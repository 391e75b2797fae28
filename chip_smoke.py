#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`splendax_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build the CUDA kernels from `splendax_torch/csrc` (one nvcc per source,
     in parallel) and print the build seconds;
  2. check the engine on the card against the engine on the CPU, ply by
     ply, on identical actions and ring;
  3. env throughput: B=32768 games, uniform random legal actions, ring
     autoreset with a 4096-row window (the workload of `bench.py`);
  4. the flagship self-play rollout: 8192 games, hidden 768, pool of 12,
     agent and pool slots loaded from the committed h768 checkpoints.  Every
     kernel launch counter is zeroed just before it and read just after;
  5. the learner: three `update_step`s of the league recipe at full width
     (one warm-up, two timed, split into rollout, GAE and epochs), with the
     loss, its gradients and GAE held against the CPU, and the kernel's
     log-probs against the autograd forward's; then the eval suite at 256
     games.  The launch counters are zeroed and read around the timed
     updates;
  6. `train.train` through its entry point into a temporary directory (1024
     games, hidden 768, 4 updates, 3 evals), its files, its npz and a
     resumed run; the launch counters are zeroed and read around it;
  7. hold each kernel against its plain PyTorch version on the card, at
     every batch and window size that phases 4 to 6 give it, and time the
     kernel, the plain version and one PyTorch library call for the
     same function at the main path's shapes, on the device clock (the
     summed kernel time under torch.profiler);
  8. a profile of four flagship turns: host time per turn, device busy time
     and the kernels that take it;
  9. the searches: without a network, `determinize`, the Gumbel search
     (plain and censored), the flat-MC Q and the PUCT root counts on the card
     equal the CPU on the same draws; with the flagship net every action is
     legal and the forced-win fixture is won; then the time per move of mc,
     gumbel, cgumbel and uct at the eval CLI's defaults on 256 games;
 10. the league recipe WITH its search slot (static, m=8, k0=4, horizon 2) at
     full width: one warm-up `update_step`, one timed, and one with the
     search timed and its launches counted; the launch counts are asserted.
     Then four of its turns under the profiler, as in 8;
 11. the engine in parity mode (MT19937 token return) on the card against
     the CPU, 100 plies x 512 games from `initial_state_parity` deals;
 12. the eval CLI on the card: `vs-search --algo gumbel --agent basic` with
     the flagship net as `--search-npz` (and `pool-elo` on the checkpoint of
     phase 6, inside that phase);
 13. the host APIs: the native C++ library built from the checkout; the gym
     env's torch backend on the card against its native backend over 8
     parity games; `core.step_autoreset` (200 plies) and
     `dual_step_autoreset` (100 turns) on the card against the CPU at
     B=8192; `SplendaxVectorEnv(8192)` in both autoreset modes on both
     backends; `DualStepSelfPlayWrapper` with
     `frozen_policy_from` on the flagship net against the float64 forward;
     `game_logger --policy model`; the flagship rollout with
     `reset_ring_mult=0` and one `update_step`, then its turns/s against the
     ring rollout's.  Kernel A's launches from the wrapper to the update are
     the "host" path.

Phases 9 to 13 run after phase 6 and before phase 7, so the host-clock
rates (phases 3 to 6 and 9 to 13) are taken before the first
torch.profiler session of the process, so that no profiler state is left
behind in them.

Prints the card's name and power limit first, a JSON line with each
kernel's numbers second to last, and `{"ok": true, "device": ...}` last.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 494.7e12  # TF32 tensor cores, dense, H100 SXM data sheet
# Kernel A against the plain float32 forward, in units of the rtol/atol 1e-5
# tolerance: that forward is itself up to 1.29x the tolerance off the float64
# one on the committed nets, and the kernel read up to 1.37x off it on an
# H100 (PERF.md).
F32_PLAIN_SLACK = 1.5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(fn, n: int, warmup: int = 3) -> tuple[float, float]:
    """(ms, host ms) per call of `fn`.  ms is the summed device time of
    every kernel that n back-to-back calls launch, from torch.profiler, over
    n; the run fails if the profiler sees no device time.  host ms is the
    wall time of n calls ending in a synchronize, over n."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    check(dev_us > 0, "the profiler saw no device time: kernel times not measured")
    return dev_us / 1e3 / n, host_ms


def realistic_obs(B: int, plies: int, seed: int, device):
    """Observations and masks of B games after `plies` random legal plies,
    with row 0's mask cleared (a row with no legal action)."""
    import torch

    from splendax_torch.env import core
    from splendax_torch.selfplay.opponents import uniform_legal_action

    g = torch.Generator(device=device).manual_seed(seed)
    state, obs, mask = core.reset(B, g, device)
    for _ in range(plies):
        state, out = core.step(state, uniform_legal_action(mask, g), mask=mask)
        obs, mask = out.obs, out.action_mask
    mask = mask.clone()
    mask[0] = False
    return obs.contiguous(), mask.contiguous()


def bound_a(B: int, H: int, with_value: bool, l1_products: int) -> tuple[float, str, float]:
    """Kernel A's least time: (ms on its own route, what bounds it, ms on the
    f32 CUDA cores).  Its route takes `l1_products` TF32 products for each
    f32 one of layer 1 (2 where every obs is exact in TF32, else 3) and 3
    for every other tensor-core product; the one-column value head is f32 on
    the CUDA cores.  Bytes: obs, mask and weights read once, outputs written
    once."""
    heads = 2 if with_value else 1
    layer1 = 2 * B * 297 * H * heads
    layer2 = 2 * B * H * H * heads
    logits = 2 * B * H * 45
    value = 2 * B * H if with_value else 0
    t_ops = ((l1_products * layer1 + 3 * (layer2 + logits)) / H100_TF32_FLOPS
             + value / H100_F32_FLOPS)
    t_f32 = (layer1 + layer2 + logits + value) / H100_F32_FLOPS
    n_weights = heads * (297 * H + H * H + 2 * H) + 45 * H + 45 + (H + 1 if with_value else 0)
    nbytes = 4 * B * 297 + B * 45 + 4 * n_weights + 4 * B * (45 + (1 if with_value else 0))
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes",
            t_f32 * 1e3)


def phase_kernels(device) -> dict:
    """Each kernel against its plain version; device-clock times at the main
    path's shapes, beside the plain version and one PyTorch library call."""
    import numpy as np
    import torch

    from splendax_torch.models import actor_critic as ac
    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.ops import ring_take as rt

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    results = {}

    # Kernel A: fused masked actor-critic forward, held within rtol/atol 1e-5
    # of its plain version in float64.  The plain version in float32 is no
    # closer than that to the exact forward on these nets (up to 1.29x the
    # tolerance), so against it the kernel is held within F32_PLAIN_SLACK
    # times the tolerance; both shares are printed.
    err_a = 0.0
    # 8192, 2048 and 3072 are the league rollout's shapes, 256 its eval's;
    # 1024 and 64 are the train phase's agent and eval forwards.  The league
    # slot's search runs 32768 playout lanes (with and without value) and a
    # root prior on 1024 rows; the search phase and the eval CLI give 32,
    # 24576 (256 games x 96 Gumbel lanes) and 92160 (256 x 45 x 8 MC lanes).
    checked_b = (1, 17, 32, 64, 256, 257, 1024, 2048, 3072, 8192, 24576, 32768, 92160)

    def share(got, want):
        """max |got - want| as a share of the rtol/atol 1e-5 tolerance."""
        got, want = got.double(), want.double()
        return ((got - want).abs() / (1e-5 + 1e-5 * want.abs())).max().item()

    for H, src in ((256, "runs/ppo_splendor_2b/ppo_splendor_params.npz"),
                   (768, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz")):
        w = ac.kernel_weights(ac.import_params_npz(os.path.join(ROOT, src), device=device))
        w64 = [t.double() for t in w]
        check(w[0].shape[1] == H, f"{src} has hidden {w[0].shape[1]}, expected {H}")
        obs_all, mask_all = realistic_obs(max(checked_b), 30, seed=H, device=device)
        err_h, shares = 0.0, [0.0, 0.0, 0.0]
        for B in checked_b:
            obs, mask = obs_all[:B].contiguous(), mask_all[:B].contiguous()
            for with_value in (True, False):
                outs = [fac.fused_masked_forward(w, obs, mask, with_value=with_value),
                        fac.fused_masked_forward_plain(w, obs, mask, with_value=with_value),
                        fac.fused_masked_forward_plain(w64, obs, mask, with_value=with_value)]
                torch.cuda.synchronize()
                for got, f32, ref in zip(*outs):
                    if got is None:
                        continue
                    where = f"H={H} B={B} value={with_value}"
                    check(torch.isfinite(got).all().item(), f"kernel A non-finite at {where}")
                    check(torch.allclose(got.double(), ref, rtol=1e-5, atol=1e-5),
                          f"kernel A disagrees with the float64 plain version at {where}: "
                          f"{share(got, ref):.3f} of the tolerance")
                    check(share(got, f32) <= F32_PLAIN_SLACK,
                          f"kernel A disagrees with the float32 plain version at {where}: "
                          f"{share(got, f32):.3f} of the tolerance, above {F32_PLAIN_SLACK}")
                    err_h = max(err_h, (got.double() - ref).abs().max().item())
                    for j, (a, b) in enumerate(((got, ref), (f32, ref), (got, f32))):
                        shares[j] = max(shares[j], share(a, b))
                check((outs[0][0][0] > -1e8).all().item(),
                      "kernel A masked a row with no legal action")
        err_a = max(err_a, err_h)
        print(f"kernel A H={H}: max abs err {err_h:.3g} vs the float64 plain version, "
              f"{shares[0]:.3f} of the rtol/atol 1e-5 tolerance; the float32 plain version: "
              f"{shares[1]:.3f} of it vs float64; kernel vs float32 plain: {shares[2]:.3f} "
              f"(at most {F32_PLAIN_SLACK}; B in {checked_b}, with and without value)", flush=True)
    # Times at H = 768: the agent forward and the bootstrap value (B = 8192,
    # with value), the pool slots' forwards (B = 2048, 3072, no value) and the
    # eval suite's greedy forward (B = 256, no value), then the league slot's
    # search: its leaves (B = 32768, with value, logits dropped), its playout
    # moves (B = 32768, no value) and its root prior (B = 1024, no value),
    # then the host policies' greedy move (B = 1, no value); each beside the
    # addmm chain for the same rows and heads.
    H = 768
    l1_products = 2 if obs_all.abs().max().item() <= 2048 else 3
    shapes = []
    for B, with_value in ((8192, True), (2048, False), (3072, False), (256, False),
                          (32768, True), (32768, False), (1024, False), (1, False)):
        obs, mask = obs_all[:B].contiguous(), mask_all[:B].contiguous()
        x32 = obs.to(torch.float32)

        def addmm_chain(x32=x32, heads=(0, 6) if with_value else (0,)):
            for o in heads:
                h = torch.tanh(torch.addmm(w[o + 1], x32, w[o]))
                h = torch.tanh(torch.addmm(w[o + 3], h, w[o + 2]))
                torch.addmm(w[o + 5], h, w[o + 4])

        ms, host_ms = device_ms(lambda: fac.fused_masked_forward(w, obs, mask, with_value), 20)
        plain_ms = device_ms(lambda: fac.fused_masked_forward_plain(w, obs, mask, with_value), 20)[0]
        library_ms = device_ms(addmm_chain, 20)[0]
        bound_ms, bound_by, bound_f32_ms = bound_a(B, H, with_value, l1_products)
        shapes.append(dict(B=B, with_value=with_value, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                           bound_f32_ms=bound_f32_ms, host_ms=host_ms))
        print(f"kernel A B={B} H={H} value={with_value}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"addmm chain {library_ms:.4f} ms (device clock); bound {bound_ms:.4f} ms by "
              f"{bound_by} (3xTF32, layer 1 in {l1_products} products), {bound_f32_ms:.4f} ms "
              f"on f32 CUDA cores; host {host_ms:.4f} ms per call", flush=True)
    agent = shapes[0]
    results["fused_actor_critic"] = dict(
        max_abs_err=err_a, **{k: agent[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                    "bound_by", "bound_f32_ms", "host_ms")},
        bound_peak="TF32 tensor cores (3xTF32), 494.7 TFLOP/s",
        checked_against="plain version in float64, rtol/atol 1e-5", by_shape=shapes,
    )

    # Kernel B: ring row take, at W = 8192 (the league rollout's window) and
    # at B = W = 1024 (the train phase's).
    rng = np.random.RandomState(0)
    R = 16384
    packed = torch.as_tensor(rng.randint(-1, 90, size=(R + 8192, 135)).astype(np.int8),
                             device=device)
    for B, W, p_done, ptr0 in ((8192, 8192, 0.03, 5), (8192, 8192, 0.5, 12000),
                               (8192, 8192, 1.0, R - 1), (8191, 8192, 0.5, 77),
                               (12000, 8192, 1.0, 3), (1024, 1024, 0.03, 5),
                               (1024, 1024, 1.0, 2047), (1500, 1024, 1.0, 3)):
        done = torch.as_tensor(rng.rand(B) < p_done, device=device)
        rank = torch.cumsum(done, 0) - done.long()
        ptr = torch.tensor(ptr0, dtype=torch.int64, device=device)
        got = rt.take_rows(packed, ptr, rank, W)
        want = rt.take_rows_plain(packed, ptr, rank, W)
        torch.cuda.synchronize()
        e = (got.int() - want.int()).abs().max().item()
        check(e == 0, f"kernel B disagrees at B={B} W={W} p={p_done}: max abs err {e}")
        if B > W and p_done == 1.0:
            check(rank.max().item() > W - 1, "the overflow case did not overflow")
    print("kernel B: exact against plain at W=8192 and W=1024, overflow cases included",
          flush=True)
    B = W = 8192
    done = torch.as_tensor(rng.rand(B) < 0.03, device=device)
    rank = torch.cumsum(done, 0) - done.long()
    ptr = torch.tensor(5, dtype=torch.int64, device=device)
    idx = ptr + torch.clamp(rank, max=W - 1)
    ms, host_ms = device_ms(lambda: rt.take_rows(packed, ptr, rank, W), 200)
    plain_ms = device_ms(lambda: rt.take_rows_plain(packed, ptr, rank, W), 200)[0]
    library_ms, library_host_ms = device_ms(lambda: torch.index_select(packed, 0, idx), 200)
    nbytes = 2 * B * 135 + 8 * B + 8
    results["ring_take"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", host_ms=host_ms,
        bound_peak="HBM3, 3.35 TB/s",
    )
    print(f"kernel B B={B} W={W}: {ms:.5f} ms (device clock), plain {plain_ms:.5f} ms, "
          f"index_select {library_ms:.5f} ms; bound {results['ring_take']['bound_ms']:.5f} ms "
          f"by bytes; host {host_ms:.4f} ms per call (index_select {library_host_ms:.4f})",
          flush=True)
    return results


def phase_engine_agreement(device) -> None:
    """The engine on the card against the engine on the CPU: identical
    actions and ring, every state field and output equal on every ply."""
    import numpy as np
    import torch

    from splendax_torch.engine import rules
    from splendax_torch.engine.state import initial_state
    from splendax_torch.env import ring as ring_lib
    from splendax_torch.eval.suite import heuristic_policy

    heuristics = {name: heuristic_policy(name)[0] for name in ("greedy_v1", "greedy_v2", "noble")}
    B, plies = 512, 300
    gen = torch.Generator().manual_seed(3)
    cpu_ring = ring_lib.make_ring(4 * B, gen, "cpu", window=B)
    st_c = initial_state(B, gen, "cpu")
    gpu_ring = cpu_ring.replace(**{k: getattr(cpu_ring, k).to(device)
                                   for k in ("packed", "mask0", "ptr", "overflow")})
    st_g = st_c.map(lambda x: x.to(device))
    rng = np.random.RandomState(3)
    mask_c = None
    finished = 0
    for ply in range(plies):
        m = (rules.legal_mask(st_c) if mask_c is None else mask_c).numpy()
        a = torch.as_tensor(np.where(m.any(1), (rng.rand(B, 45) * m).argmax(1), 0))
        st_c, out_c, obs_c, mask_c, cpu_ring = ring_lib.step_autoreset_ring(st_c, a, cpu_ring)
        st_g, out_g, obs_g, mask_g, gpu_ring = ring_lib.step_autoreset_ring(
            st_g, a.to(device), gpu_ring)
        for name, x in st_c.items():
            check(torch.equal(x, getattr(st_g, name).cpu()), f"engine: {name} differs at ply {ply}")
        for name, x, y in (("obs", obs_c, obs_g), ("mask", mask_c, mask_g),
                           ("reward", out_c.reward, out_g.reward),
                           ("final_rewards", out_c.final_rewards, out_g.final_rewards),
                           ("ptr", cpu_ring.ptr, gpu_ring.ptr)):
            check(torch.equal(x, y.cpu()), f"engine: {name} differs at ply {ply}")
        for name, fn in heuristics.items():
            check(torch.equal(fn(None, obs_c, mask_c, st_c, None),
                              fn(None, obs_g, mask_g, st_g, None).cpu()),
                  f"heuristic {name}: card differs from CPU at ply {ply}")
        finished += int(out_c.terminated.sum())
    check(finished > 0, "engine agreement run finished no game")
    print(f"engine: card equals CPU on {plies} plies x {B} games ({finished} games ended); "
          f"so do the heuristics {sorted(heuristics)}", flush=True)


def phase_env(device) -> float:
    """Env steps/s at B=32768 with ring autoreset (bench.py's workload)."""
    import torch

    from splendax_torch.env import core
    from splendax_torch.env import ring as ring_lib
    from splendax_torch.selfplay.opponents import uniform_legal_action

    B, steps = 32768, 64
    g = torch.Generator(device=device).manual_seed(0)
    state, obs, mask = core.reset(B, g, device)

    def run(n):
        nonlocal state, mask
        ring = ring_lib.make_ring(B * max(1, -(-n // 64)), g, device, window=4096)
        obs_sum = torch.zeros((), dtype=torch.int64, device=device)
        r_sum = torch.zeros((), device=device)
        for _ in range(n):
            action = uniform_legal_action(mask, g)
            state, out, obs, mask, ring = ring_lib.step_autoreset_ring(state, action, ring, mask=mask)
            obs_sum += obs.sum()
            r_sum += out.reward.sum()
        return ring.overflow

    run(4)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    overflow = run(steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(int(overflow) == 0, f"ring window overflow: {int(overflow)} lanes")
    rate = B * steps / dt
    print(f"env: {rate:.1f} env-steps/s (B={B}, {steps} steps, ring window 4096, "
          f"{dt:.3f} s incl. ring deal)", flush=True)
    return rate


def flagship_state(cfg, device):
    """A TrainState at flagship width: the agent from the committed 2B-step
    h768 run, two frozen pool slots from the 4B-step and the distilled h768
    nets."""
    from splendax_torch.models.actor_critic import import_params_npz
    from splendax_torch.selfplay import pool as pool_lib
    from splendax_torch.train import ppo

    agent = import_params_npz(os.path.join(ROOT, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"),
                              device=device)
    ts = ppo.init_train_state(cfg, params=agent, device=device)
    pool = ts.pool
    for src in ("runs/ppo_splendor_4b_h768/ppo_splendor_params.npz",
                "runs/distill_h768/distilled_params.npz"):
        pool = pool_lib.push_snapshot(pool, import_params_npz(os.path.join(ROOT, src), device=device))
    ts.pool = pool
    ts.opp_idx = ppo._sample_opponents(cfg, pool, ts.generator, cfg.num_envs)
    return ts


def read_launches() -> dict:
    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.ops import ring_take as rt

    return {"fused_actor_critic": fac.launches, "ring_take": rt.launches}


def zero_launches() -> None:
    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.ops import ring_take as rt

    fac.launches = 0
    rt.launches = 0


def phase_rollout(device):
    """The flagship rollout through the port's entry points."""
    import torch

    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.train import ppo
    from splendax_torch.train.config import PPOConfig

    cfg = PPOConfig(num_envs=8192, num_steps=64, hidden=768, pool_size=12, p_current=0.25,
                    reset_ring_mult=2, rng_mode="fast")
    ts = flagship_state(cfg, device)

    ppo.rollout(cfg.replace(num_steps=2), ts)  # warm-up, not kept
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ts, traj = ppo.rollout(cfg, ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()

    legal = traj.mask.gather(2, traj.action[..., None])[..., 0]
    check(bool((legal | ~traj.mask.any(-1)).all()), "an agent action was illegal")
    check(torch.isfinite(traj.logp).all().item() and torch.isfinite(traj.value).all().item(),
          "non-finite logp or value")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    episodes = int(traj.done.sum())
    check(episodes > 0, "no episode finished")
    check(int(traj.overflow) == 0, f"ring overflow {int(traj.overflow)}")
    # The last turn's logp against the plain forward on the same inputs.
    t = cfg.num_steps - 1
    w = ts.pool.slot(ts.pool.pool_size)
    lp, _ = fac.fused_masked_forward_plain(w, traj.obs[t], traj.mask[t])
    want = torch.log_softmax(lp, -1).gather(1, traj.action[t][:, None])[:, 0]
    e = (want - traj.logp[t]).abs().max().item()
    check(e < 1e-4, f"rollout logp disagrees with the plain forward: {e}")
    won = int(((traj.reward > 0.5) & traj.done).sum())
    turns_per_s = cfg.num_steps / dt
    print(f"rollout: {turns_per_s:.3f} turns/s = {turns_per_s * cfg.num_envs:.1f} agent "
          f"steps/s (N={cfg.num_envs}, T={cfg.num_steps}, H={cfg.hidden}, "
          f"{dt:.3f} s incl. ring deal); {episodes} episodes, {won} won; launches {launches}",
          flush=True)
    return launches, cfg, ts


@contextlib.contextmanager
def timed_learner_phases(ppo, seconds: dict, last: dict):
    """While open, `ppo.rollout`, `ppo._gae` and `ppo._ppo_epochs` add their
    synchronised host seconds to `seconds` and leave their last arguments
    and results in `last`."""
    import torch

    originals = {name: getattr(ppo, name) for name in ("rollout", "_gae", "_ppo_epochs")}

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            last[name] = (args, out)
            return out
        return wrapper

    for name, fn in originals.items():
        setattr(ppo, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(ppo, name, fn)


def phase_update(device) -> dict:
    """The league recipe's learner at full width: one warm-up `update_step`,
    two timed ones, and the learner's arithmetic held against the CPU."""
    import torch

    from splendax_torch.eval import suite
    from splendax_torch.models import actor_critic as ac
    from splendax_torch.train import ppo
    from splendax_torch.train.config import PPOConfig

    # runs/ppo_splendor_2b_h768_league/config.json without its search slot.
    cfg = PPOConfig(num_envs=8192, num_steps=64, hidden=768, pool_size=12, p_current=0.25,
                    reset_ring_mult=2, minibatch_size=32768, update_epochs=4, lr=2.5e-4,
                    lr_anneal=True, target_kl=0.02, snapshot_every_updates=16,
                    total_timesteps=2_000_000_000, rng_mode="fast")
    eval_games = 256
    check(not torch.backends.cuda.matmul.allow_tf32, "the learner's products must be float32")
    ts = flagship_state(cfg, device)
    before = [p.detach().clone() for p in ts.params.parameters()]
    ts, _ = ppo.update_step(cfg, ts)  # warm-up, not timed
    torch.cuda.synchronize()

    n_updates = 2
    seconds, last, counts = {}, {}, []
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with timed_learner_phases(ppo, seconds, last):
        for _ in range(n_updates):
            count0 = ts.opt_state.count
            ts, metrics = ppo.update_step(cfg, ts)
            counts.append(ts.opt_state.count - count0)
            values = {k: v.item() for k, v in metrics.items()}
            check(all(v == v and abs(v) != float("inf") for v in values.values()),
                  f"update: a metric is not finite: {values}")
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_updates
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches["fused_actor_critic"] >= n_updates * (cfg.num_steps + 1),
          f"update: kernel A launched {launches['fused_actor_critic']} times")
    check(launches["ring_take"] == n_updates * cfg.num_steps,
          f"update: kernel B launched {launches['ring_take']} times")
    after = list(ts.params.parameters())
    check(all(torch.isfinite(p).all().item() for p in after), "update: a parameter is not finite")
    check(any(not torch.equal(a, b) for a, b in zip(before, after)), "update: no parameter moved")
    check(ts.update_idx == 3 and ts.global_step == 3 * cfg.batch_size, "update: wrong counters")
    per = {k: v / n_updates for k, v in seconds.items()}
    steps = sum(counts) / n_updates
    print(f"update: {dt:.4f} s per update_step = {cfg.batch_size / dt:.1f} agent steps/s "
          f"(N={cfg.num_envs}, T={cfg.num_steps}, H={cfg.hidden}, minibatch {cfg.minibatch_size}, "
          f"{cfg.update_epochs} epochs): rollout {per['rollout']:.4f} s, GAE {per['_gae']:.4f} s, "
          f"epochs {per['_ppo_epochs']:.4f} s in {steps:.1f} optimizer steps "
          f"({1e3 * per['_ppo_epochs'] / max(steps, 1):.3f} ms a minibatch; the KL stop left "
          f"{counts} of {cfg.update_epochs * cfg.num_minibatches} steps); "
          f"peak memory {peak} bytes; launches {launches}; last metrics {values}", flush=True)

    # GAE on the card against GAE on the CPU, on the last update's rollout.
    (_, traj, last_value), (adv, returns) = last["_gae"]
    cpu_traj = ppo.Rollout(**{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                              for k, v in vars(traj).items()})
    adv_c, ret_c = ppo._gae(cfg, cpu_traj, last_value.cpu())
    e = max((adv.cpu() - adv_c).abs().max().item(), (returns.cpu() - ret_c).abs().max().item())
    check(e < 1e-5, f"GAE on the card differs from the CPU by {e}")

    # The loss and every gradient on the card (float32) against the CPU in
    # float64, on 4,096 rows spread over the last rollout: rtol 1e-4, with an
    # atol of 1e-5 of each tensor's largest value for the entries near 0.
    (_, _, batch, _, ent_coef), _ = last["_ppo_epochs"]
    rows = [x[::max(1, cfg.batch_size // 4096)].contiguous() for x in batch]
    model = ts.params
    loss, aux = ppo.ppo_loss(cfg, ent_coef, model, *rows)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    model64 = copy.deepcopy(model).cpu().double()
    rows64 = [x.cpu().double() if x.is_floating_point() else x.cpu() for x in rows]
    loss64, aux64 = ppo.ppo_loss(cfg, ent_coef, model64, *rows64)
    grads64 = torch.autograd.grad(loss64, list(model64.parameters()))
    worst = 0.0
    for name, got, want in ([("loss", loss, loss64)]
                            + [(f"aux[{i}]", a, b) for i, (a, b) in enumerate(zip(aux, aux64))]
                            + [(f"grad[{i}]", a, b) for i, (a, b) in enumerate(zip(grads, grads64))]):
        got = got.detach().cpu().double()
        atol = 1e-5 * want.abs().max().item()
        err = ((got - want).abs() / (atol + 1e-4 * want.abs())).max().item()
        check(err <= 1.0, f"ppo_loss {name} on the card is {err:.3f} of rtol 1e-4 off float64")
        worst = max(worst, err)
    print(f"update: GAE card vs CPU max abs err {e:.3g}; ppo_loss and 12 gradients on {rows[0].shape[0]} rows "
          f"within {worst:.3f} of rtol 1e-4 of the CPU in float64", flush=True)

    # The eval suite at the league recipe's eval_games=256 (four matches).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = suite.run_evaluation_suite(ts.params, eval_games, seed=0, device=device)
    torch.cuda.synchronize()
    dt_eval = time.perf_counter() - t0
    check(all(r["n"] == eval_games and r["illegal_action_rate"] == 0 for r in results.values()),
          f"eval: {results}")
    print(f"eval: {4 * eval_games / dt_eval:.1f} games/s ({dt_eval:.3f} s for 4 matches of "
          f"{eval_games} games); "
          + ", ".join(f"{k} wr={r['win_rate']:.3f} turns={r['avg_turns']:.1f}"
                      for k, r in results.items()), flush=True)

    # Kernel A's log-probs against the autograd forward's: an update cut to
    # one minibatch at lr 0 reads approx_kl = mean(logp_kernel - logp_autograd),
    # a signed mean in which errors cancel, so every row of that rollout is
    # also held within 1e-4 (lr 0 leaves the parameters where they were).
    probe = cfg.replace(num_steps=4, minibatch_size=4 * cfg.num_envs, update_epochs=1, lr=0.0,
                        lr_anneal=False, snapshot_every_updates=10**9)
    with timed_learner_phases(ppo, {}, last):
        ts, m = ppo.update_step(probe, ts)
    kl = m["approx_kl"].item()
    check(abs(kl) < 1e-4, f"kernel A's logp is {kl} off the autograd forward's in approx_kl")
    p_obs, p_mask, p_action, p_logp = last["_ppo_epochs"][0][2][:4]
    with torch.no_grad():
        new_logp, _ = ac.log_prob_entropy(ts.params(p_obs)[0], p_mask, p_action)
    row_err = (new_logp - p_logp).abs().max().item()
    check(row_err < 1e-4, f"kernel A's logp is {row_err} off the autograd forward's on a row")
    print(f"update: approx_kl of one minibatch at lr 0 (kernel logp vs autograd): {kl:.3g}; "
          f"max over its {p_logp.shape[0]} rows of |logp_kernel - logp_autograd|: {row_err:.3g}",
          flush=True)

    # What the KL stop's host read costs: the last full rollout's epochs at
    # lr 0, once without the read (target_kl 0) and once with a read a
    # minibatch that never stops (target_kl 1e9).
    times = {0.0: [], 1e9: []}
    for target_kl in (0.0, 1e9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppo._ppo_epochs(cfg.replace(target_kl=target_kl), ts, batch, 0.0, ent_coef)
        torch.cuda.synchronize()
        times[target_kl].append(time.perf_counter() - t0)
    n = cfg.update_epochs * cfg.num_minibatches
    print(f"update: {n} minibatch steps without the KL read {times[0.0]} s, with it "
          f"{times[1e9]} s", flush=True)
    return launches


def phase_train(device) -> dict:
    """`train.train` through its entry point on the card: small depth, the
    flagship's hidden width."""
    import numpy as np
    import torch

    from splendax_torch.models.actor_critic import import_params_npz
    from splendax_torch.train import train

    with tempfile.TemporaryDirectory() as log_dir:
        cfg = train.parse_args([
            "--num-envs", "1024", "--num-steps", "16", "--hidden", "768",
            "--total-timesteps", str(4 * 16384), "--eval-games", "64",
            "--eval-every-updates", "2", "--checkpoint-every-updates", "1",
            "--snapshot-every-updates", "2", "--log-dir", log_dir])
        zero_launches()
        t0 = time.perf_counter()
        ts = train.train(cfg, device=device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        # Each update: a turn launches kernel A for the agent and for at least
        # one pool slot, then the bootstrap value; kernel B once a turn.
        n_up, T = 4, cfg.num_steps
        check(launches["fused_actor_critic"] >= n_up * (2 * T + 1),
              f"train: kernel A launched {launches['fused_actor_critic']} times")
        check(launches["ring_take"] == n_up * T,
              f"train: kernel B launched {launches['ring_take']} times")
        check(ts.update_idx == 4, f"train: ended at update {ts.update_idx}")
        for name in ("ppo_splendor_latest.pt", "config.json", "metrics.jsonl",
                     "ppo_splendor_params.npz"):
            check(os.path.isfile(os.path.join(log_dir, name)), f"train: {name} is missing")
        again = import_params_npz(os.path.join(log_dir, "ppo_splendor_params.npz"), device=device)
        check(all(torch.equal(a, b) for a, b in zip(again.parameters(), ts.params.parameters())),
              "train: the npz does not reload to the trained parameters")
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        evals = [r for r in recs if r["type"] == "eval"]
        check([r["step"] for r in evals] == [0, 2 * 16384, 4 * 16384], "train: wrong eval cadence")
        for r in evals:
            for name in ("random", "greedy_v1", "basic", "self"):
                check(r[name]["n"] == 64 and r[name]["illegal_action_rate"] == 0,
                      f"train: eval vs {name} at step {r['step']}: {r[name]}")
        trained = [r for r in recs if r["type"] == "train"]
        check(len(trained) == 4 and all(np.isfinite(list(r.values())[1:]).all() for r in trained),
              f"train: metrics {trained}")
        # A resumed run starts at update 4, evaluates nothing and trains nothing.
        calls = []
        resumed = train.train(cfg.replace(resume=True), eval_fn=lambda p, seed: calls.append(seed),
                              device=device)
        check(resumed.update_idx == 4 and not calls
              and resumed.opt_state.count == ts.opt_state.count
              and all(torch.equal(a, b) for a, b in zip(resumed.params.parameters(),
                                                        ts.params.parameters())),
              "train: the resumed run did not start where the first ended")
        # The Elo ladder over the checkpoint's pool: two snapshots and CURRENT.
        from splendax_torch.eval import cli

        elo_json = os.path.join(log_dir, "elo.json")
        t0 = time.perf_counter()
        cli.main(["pool-elo", "--checkpoint", os.path.join(log_dir, "ppo_splendor_latest.pt"),
                  "--games", "16", "--json-out", elo_json], device=device)
        dt_elo = time.perf_counter() - t0
        with open(elo_json) as f:
            league = json.load(f)
        check(sorted(league["elo"]) == ["current", "snap0", "snap1"]
              and len(league["pairs"]) == 6 and all(r["n"] == 16 for r in league["pairs"].values())
              and abs(sum(league["elo"].values()) / 3 - 1000.0) < 1e-6,
              f"pool-elo: {league['elo']}")
        print(f"cli pool-elo: 6 ordered pairs of 16 games in {dt_elo:.3f} s; Elo {league['elo']}",
              flush=True)
    print(f"train: 4 updates of {cfg.num_envs} x {cfg.num_steps} at H={cfg.hidden} with 3 evals of "
          f"4 x {cfg.eval_games} games in {dt:.3f} s; files, npz and resume check out; "
          f"launches {launches}", flush=True)
    return launches


def forced_win_state(device):
    """Player 0 at 14 prestige holding the tokens to buy the one card on the
    board, a 1-point card: action 15 wins on the spot."""
    import torch

    from splendax_torch.engine.state import initial_state_parity

    st = initial_state_parity(3, device)
    st.prestige[0] = torch.tensor([14, 0], dtype=torch.int32)
    st.tokens[0, 0] = torch.tensor([7, 7, 7, 7, 7, 3], dtype=torch.int32)
    st.board[:] = -1
    st.board[0, 0, 0] = 7  # tier-1 card 7: 1 point
    return st


def phase_search(device) -> dict:
    """The four searches on the card: exact against the CPU without a
    network, sane with the flagship net, and timed at the CLI's defaults."""
    import torch

    from splendax_torch import search
    from splendax_torch.engine import rules
    from splendax_torch.engine.encode import encode_observation
    from splendax_torch.env import core
    from splendax_torch.models.actor_critic import import_params_npz, kernel_weights
    from splendax_torch.search import gumbel, ismc, mc, uct
    from splendax_torch.selfplay.opponents import uniform_legal_action

    def midgame(B, plies, seed, dev):
        g = torch.Generator(device=dev).manual_seed(seed)
        state, obs, mask = core.reset(B, g, dev)
        for _ in range(plies):
            state, out = core.step(state, uniform_legal_action(mask, g), mask=mask)
            obs, mask = out.obs, out.action_mask
        return state, obs, mask

    def on(dev, x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, dict):
            return {k: on(dev, v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [on(dev, v) for v in x]
        return x.map(lambda t: t.to(dev))  # a GameState

    # Without a network, on the same draws: the card equals the CPU exactly.
    B, m, k0, hz = 64, 8, 2, 2
    cg = torch.Generator().manual_seed(11)
    st_c, obs_c, mask_c = midgame(B, 41, 5, "cpu")  # player 1 to move, reserves on both sides
    rounds = m.bit_length() - 1
    draws = {
        "g": gumbel.gumbel_noise((B, 45), cg, "cpu"),
        "playout": [[torch.rand(B * m * k0, generator=cg) for _ in range(hz)] for _ in range(rounds)],
        "det": [torch.rand((B * (m * k0 // (m >> r)), 3, ismc.EXT), generator=cg)
                for r in range(rounds)],
    }
    st_g, obs_g, mask_g, draws_g = on(device, st_c), on(device, obs_c), on(device, mask_c), on(device, draws)
    u = torch.rand((B, 3, ismc.EXT), generator=cg)
    det_c, det_g = ismc.determinize(st_c, u=u), ismc.determinize(st_g, u=u.to(device))
    moved = 0
    for name, x in det_c.items():
        check(torch.equal(x, getattr(det_g, name).cpu()), f"determinize: {name} differs on the card")
        moved += int((x != getattr(st_c, name)).sum())
    check(moved > 0, "determinize moved nothing")
    check(torch.equal(encode_observation(det_g), obs_g), "determinize changed the observation")
    for censored in (False, True):
        fn = gumbel.gumbel_search_fn(m=m, k0=k0, horizon=hz,
                                     determinize_fn=ismc.determinize if censored else None)
        info_c, info_g = {}, {}
        a_c = fn(None, obs_c, mask_c, st_c, draws=draws, info=info_c)
        a_g = fn(None, obs_g, mask_g, st_g, draws=draws_g, info=info_g)
        check(torch.equal(a_c, a_g.cpu()) and torch.equal(info_c["q_hat"], info_g["q_hat"].cpu()),
              f"gumbel search (censored={censored}): the card differs from the CPU")
        check(bool((mask_c.gather(1, a_c[:, None])[:, 0] | ~mask_c.any(1)).all()),
              "gumbel search: illegal action")
    mc_draws = [torch.rand(B * 45 * 2, generator=cg) for _ in range(3)]
    q_c = mc.mc_search_q(2, 3)(None, obs_c, mask_c, st_c, draws=mc_draws)
    q_g = mc.mc_search_q(2, 3)(None, obs_g, mask_g, st_g, draws=on(device, mc_draws))
    check(torch.equal(q_c, q_g.cpu()), "mc_search_q: the card differs from the CPU")
    n_c, rq_c = uct.uct_search(st_c.map(lambda x: x[:32]), None, 16, 8, 1.5)
    n_g, rq_g = uct.uct_search(st_g.map(lambda x: x[:32]), None, 16, 8, 1.5)
    check(torch.equal(n_c, n_g.cpu()) and torch.equal(rq_c, rq_g.cpu()),
          "uct: root counts or values on the card differ from the CPU")
    check(bool((n_c.sum(1) == 16).all()), "uct: a simulation did not back up through the root")
    print(f"search: without a network the card equals the CPU on the same draws: determinize "
          f"({moved} entries moved, obs unchanged), gumbel m{m} k{k0} h{hz} plain and censored "
          f"(actions and mean values), mc_search_q r2 h3, uct root counts and values at 16 sims "
          f"({B} games, 32 for uct)", flush=True)

    # With the flagship net: legal actions, and the forced win is taken.
    net = import_params_npz(os.path.join(ROOT, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"),
                            device=device)
    w = kernel_weights(net)
    gen = torch.Generator(device=device).manual_seed(1)
    win = forced_win_state(device)
    win_obs, win_mask = encode_observation(win), rules.legal_mask(win)
    check(bool(win_mask[0, 15]), "the forced-win fixture cannot buy")
    specs = {
        "mc": search.mc_search_policy(1, 1, net),
        "cmc": search.censored_mc_policy(1, 1, net),
        "uct": search.uct_search_policy(64, net),
        "gumbel": search.gumbel_search_policy(m=32, k0=2, horizon=1, params=net, c_scale=1e4),
        "cgumbel": search.censored_gumbel_policy(m=32, k0=2, horizon=1, params=net, c_scale=1e4),
    }
    for name, (fn, ctx) in specs.items():
        a = int(fn(ctx, win_obs, win_mask, win, gen)[0])
        check(a == 15, f"{name} with the flagship net played {a} on the forced-win fixture")
    small = {
        "mc": search.mc_search_policy(2, 4, net), "cmc": search.censored_mc_policy(2, 4, net),
        "uct": search.uct_search_policy(16, net, max_depth=8),
        "gumbel": search.gumbel_search_policy(8, 4, 2, net, greedy_final=True),
        "cgumbel": search.censored_gumbel_policy(8, 4, 2, net),
    }
    for name, (fn, ctx) in small.items():
        a = fn(ctx, obs_g, mask_g, st_g, gen)
        check(bool((mask_g.gather(1, a[:, None])[:, 0] | ~mask_g.any(1)).all()),
              f"{name} with the flagship net: illegal action")
    print("search: with the flagship net every action is legal and mc, cmc, uct, gumbel and "
          "cgumbel all buy the winning card", flush=True)

    # Time per move at the eval CLI's defaults, 256 games in mid-game, with
    # the flagship net (as --search-npz) and without one.
    st, obs, mask = midgame(256, 30, 9, device)
    times = {}
    for label, leaf in (("net", net), ("no net", None)):
        timed = {
            "mc": search.mc_search_policy(8, 24, leaf),
            "gumbel": search.gumbel_search_policy(16, 6, 24, leaf),
            "cgumbel": search.censored_gumbel_policy(16, 6, 24, leaf),
            "uct": search.uct_search_policy(64, leaf),
        }
        for name, (fn, ctx) in timed.items():
            if label == "no net" and name == "cgumbel":
                continue
            fn(ctx, obs, mask, st, gen)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            a = fn(ctx, obs, mask, st, gen)
            torch.cuda.synchronize()
            times[f"{name} ({label})"] = time.perf_counter() - t0
            check(bool((mask.gather(1, a[:, None])[:, 0] | ~mask.any(1)).all()),
                  f"{name}: illegal action at 256 games")
            print(f"search: {fn.__name__} ({label}) {times[f'{name} ({label})']:.4f} s per move of "
                  f"256 games; peak memory {torch.cuda.max_memory_allocated()} bytes", flush=True)
    return times


def league_cfg():
    """runs/ppo_splendor_2b_h768_league/config.json, its search slot
    included."""
    from splendax_torch.train.config import PPOConfig

    return PPOConfig(num_envs=8192, num_steps=64, hidden=768, pool_size=12, p_current=0.25,
                     reset_ring_mult=2, minibatch_size=32768, update_epochs=4, lr=2.5e-4,
                     lr_anneal=True, target_kl=0.02, snapshot_every_updates=16,
                     total_timesteps=2_000_000_000, rng_mode="fast", eval_games=256,
                     search_opponent=True, search_static=True, p_search=0.125, search_m=8,
                     search_k0=4, search_horizon=2)


def phase_league(device):
    """The league recipe with its search slot at full width: a warm-up
    update, a timed one, and one more with the search timed on its own."""
    import torch

    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.train import ppo

    cfg = league_cfg()
    S = cfg.n_search_static
    check(S == 1024 and cfg.search_stride == 8, f"static slot: {S} rows, stride {cfg.search_stride}")
    ts = flagship_state(cfg, device)
    sent = ts.pool.pool_size + 1
    check(int((ts.opp_idx == sent).sum()) == S and bool((ts.opp_idx[::8] == sent).all()),
          "the static sentinel rows are not rows 0, 8, 16, ...")
    ts, _ = ppo.update_step(cfg, ts)  # warm-up, not timed
    torch.cuda.synchronize()

    # Kernel A per turn, as the code implies: the agent forward; one per
    # pool slot that has games (1 to 3 here: two frozen slots and CURRENT);
    # in the search the root prior, then per halving round `horizon` guided
    # playout plies and one leaf evaluation.  Plus the bootstrap value.
    rounds = cfg.search_m.bit_length() - 1
    per_search = 1 + rounds * (cfg.search_horizon + 1)
    T = cfg.num_steps
    seconds, last = {}, {}
    steps0 = ts.opt_state.count
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with timed_learner_phases(ppo, seconds, last):
        ts, metrics = ppo.update_step(cfg, ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = ts.opt_state.count - steps0
    values = {k: v.item() for k, v in metrics.items()}
    check(all(v == v and abs(v) != float("inf") for v in values.values()),
          f"league: a metric is not finite: {values}")
    lo, hi = T * (1 + 1 + per_search) + 1, T * (1 + 3 + per_search) + 1
    check(lo <= launches["fused_actor_critic"] <= hi,
          f"league: kernel A launched {launches['fused_actor_critic']} times, not {lo}..{hi}")
    check(launches["ring_take"] == T, f"league: kernel B launched {launches['ring_take']} times")
    traj = last["rollout"][1][1]
    check(int(traj.overflow) == 0 and int(traj.done.sum()) > 0, "league: ring overflow or no episode")
    check(int((ts.opp_idx == sent).sum()) == S, "league: the sentinel rows moved")
    check(float(ts.pool.games.sum()) == 0.0, "league: uniform sampling keeps no PFSP counts")
    print(f"league update (with its search slot, static, m{cfg.search_m} k{cfg.search_k0} "
          f"h{cfg.search_horizon}, {S} sentinel rows): {dt:.4f} s per update_step = "
          f"{cfg.batch_size / dt:.1f} agent steps/s: rollout {seconds['rollout']:.4f} s "
          f"({100 * seconds['rollout'] / dt:.1f}%), GAE {seconds['_gae']:.4f} s, epochs "
          f"{seconds['_ppo_epochs']:.4f} s in {steps} optimizer steps (the KL stop left that many "
          f"of {cfg.update_epochs * cfg.num_minibatches}); peak memory {peak} bytes; "
          f"launches {launches} "
          f"(kernel A {launches['fused_actor_critic'] / T:.2f} a turn incl. the bootstrap; "
          f"{per_search} of them in the search); last metrics {values}", flush=True)

    # Once more with the search timed on its own (two synchronisations a turn).
    made = ppo.gumbel_search_fn
    spent = {"s": 0.0, "calls": 0, "launches": 0}

    def timed_factory(*args, **kw):
        fn = made(*args, **kw)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), fac.launches
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1
            spent["launches"] += fac.launches - n0
            return out
        return timed

    ppo.gumbel_search_fn = timed_factory
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, traj2 = ppo.rollout(cfg, ts)
        torch.cuda.synchronize()
        dt_roll = time.perf_counter() - t0
    finally:
        ppo.gumbel_search_fn = made
    check(spent["calls"] == T and spent["launches"] == T * per_search,
          f"league: {spent['calls']} searches launched kernel A {spent['launches']} times, "
          f"not {T} x {per_search}")
    print(f"league rollout with the search timed: {dt_roll:.4f} s for {T} turns; the search "
          f"{1e3 * spent['s'] / T:.3f} ms per opponent move ({100 * spent['s'] / dt_roll:.1f}% of "
          f"the rollout), {per_search} kernel A launches each on up to "
          f"{S * cfg.search_m * cfg.search_k0} lanes", flush=True)
    return launches, cfg, ts


def phase_parity(device) -> None:
    """The engine in parity mode (MT19937 token return) on the card against
    the CPU, from `initial_state_parity` deals, on identical actions."""
    import numpy as np
    import torch

    from splendax_torch.engine import rules
    from splendax_torch.engine.state import initial_state_parity
    from splendax_torch.env import core

    B, plies = 512, 100
    st_c = initial_state_parity(range(1000, 1000 + B), "cpu")
    st_g = st_c.map(lambda x: x.to(device))
    rng = np.random.RandomState(5)
    returned = 0
    t0 = time.perf_counter()
    for ply in range(plies):
        mask = rules.legal_mask(st_c)
        m = mask.numpy()
        a = torch.as_tensor(np.where(m.any(1), (rng.rand(B, 45) * m).argmax(1), 0))
        # A mover who holds 10 tokens and takes more must return some.
        held = st_c.tokens[torch.arange(B), st_c.to_play.long()].sum(1)
        returned += int(((held == 10) & (a < 15) & mask.any(1)).sum())
        st_c, out_c = core.step(st_c, a, rng_mode="parity", mask=mask)
        st_g, out_g = core.step(st_g, a.to(device), rng_mode="parity")
        for name, x in st_c.items():
            check(torch.equal(x, getattr(st_g, name).cpu()), f"parity: {name} differs at ply {ply}")
        for name in ("obs", "action_mask", "reward", "terminated", "final_rewards"):
            check(torch.equal(getattr(out_c, name), getattr(out_g, name).cpu()),
                  f"parity: {name} differs at ply {ply}")
    check(returned > 0, "parity: no game reached the token cap")
    print(f"parity: the engine in parity mode on the card equals the CPU on {plies} plies x {B} "
          f"games ({returned} takes from a full hand of 10, each a token return) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def phase_cli(device) -> None:
    """The eval CLI on the card: the basic heuristic against the Gumbel
    search with the flagship net."""
    from splendax_torch.eval import cli

    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "vs_search.json")
        t0 = time.perf_counter()
        cli.main(["vs-search", "--algo", "gumbel", "--agent", "basic", "--games", "32",
                  "--horizon", "4", "--greedy-final", "--search-npz",
                  os.path.join(ROOT, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"),
                  "--json-out", path], device=device)
        dt = time.perf_counter() - t0
        with open(path) as f:
            res = json.load(f)
    (name, r), = res.items()
    check(name == "basic_vs_gumbel(m16,k6,h4)" and r["n"] == 32 and r["illegal_action_rate"] == 0
          and r["privileged"] == {"agent": False, "opponent": True}, f"cli vs-search: {res}")
    check(r["losses"] > r["wins"], f"cli vs-search: basic beat the flagship's search: {r}")
    print(f"cli vs-search: {name} over 32 games in {dt:.3f} s: basic won {r['wins']}, "
          f"lost {r['losses']}", flush=True)


def same_step(got, want) -> bool:
    """Two gym step results equal: obs, flags and every info entry exactly,
    rewards as float32 (the native engine returns C++ doubles, -0.01 where
    float32 reads -0.009999999776)."""
    import numpy as np

    f32 = np.float32
    (o1, r1, t1, tr1, i1), (o2, r2, t2, tr2, i2) = got, want
    if not (np.array_equal(o1, o2) and (f32(r1), t1, tr1) == (f32(r2), t2, tr2)
            and sorted(i1) == sorted(i2)):
        return False
    for k, v in i2.items():
        w = i1[k]
        if isinstance(v, np.ndarray):
            ok = np.array_equal(w, v) and w.dtype == v.dtype
        elif isinstance(v, dict):
            ok = {p: f32(x) for p, x in w.items()} == {p: f32(x) for p, x in v.items()}
        else:
            ok = w == v
        if not ok:
            return False
    return True


def phase_host(device) -> dict:
    """The host APIs on the card: the native library built from the repo,
    the single env's torch backend on the card against its native backend,
    the full-batch autoreset on the card against the CPU, the vector env,
    the self-play wrapper with the flagship net, the flagship rollout with
    `reset_ring_mult=0` and one `update_step`, and a logged game.  The
    launch counts are zeroed before the wrapper and read after the update."""
    import io

    import numpy as np
    import torch

    from splendax_torch import native
    from splendax_torch.env import _gym, core
    from splendax_torch.env.gym_compat import SplendorEnv
    from splendax_torch.env.vector import SplendaxVectorEnv
    from splendax_torch.models import actor_critic as ac
    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.selfplay import dual, opponents, wrappers
    from splendax_torch.selfplay.opponents import uniform_legal_action
    from splendax_torch.tools import game_logger
    from splendax_torch.train import ppo
    from splendax_torch.train.config import PPOConfig

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native._load()
    print(f"host: native library built from splendax_torch/native/engine.cpp and loaded in "
          f"{time.perf_counter() - t0:.2f} s; gymnasium: "
          + (_gym.gym.__version__ if _gym.HAVE_GYMNASIUM else "absent (stand-ins)"), flush=True)

    # The single env: torch on the card against native, 8 whole parity games.
    rng = np.random.RandomState(0)
    secs, steps, plies = {"torch": 0.0, "native": 0.0}, 0, []
    for game in range(8):
        envs = {b: SplendorEnv(backend=b, device=device) for b in ("torch", "native")}
        res = {b: e.reset(seed=100 + game) for b, e in envs.items()}
        check(same_step(*[(o, 0.0, False, False, i) for o, i in res.values()]),
              f"single env: reset differs in game {game}")
        info = res["native"][1]
        for ply in range(400):
            legal = np.flatnonzero(info["action_mask"])
            a = int(rng.choice(legal)) if len(legal) else 0
            if game == 0 and ply == 3:
                a = int(np.flatnonzero(info["action_mask"] == 0)[0])  # an illegal action
            for b, e in envs.items():
                t0 = time.perf_counter()
                res[b] = e.step(a)
                secs[b] += time.perf_counter() - t0
            steps += 1
            check(same_step(res["torch"], res["native"]),
                  f"single env: torch on the card differs from native at game {game} ply {ply}")
            if game == 0 and ply == 3:
                check(res["torch"][4].get("illegal_action") is True, "the illegal action passed")
            info = res["native"][4]
            if res["native"][2]:
                break
        check(res["native"][2], f"single env: game {game} did not end")
        plies.append(ply + 1)
    cpu_env = SplendorEnv(backend="torch", device="cpu")
    _, info = cpu_env.reset(seed=1)
    t0 = time.perf_counter()
    for n_cpu in range(1, 151):
        legal = np.flatnonzero(info["action_mask"])
        _, _, term, _, info = cpu_env.step(int(rng.choice(legal)) if len(legal) else 0)
        if term:
            _, info = cpu_env.reset()
    cpu_rate = n_cpu / (time.perf_counter() - t0)
    print(f"host: SplendorEnv torch on the card equals native on every ply of 8 parity games "
          f"({plies} plies, one illegal action); steps/s: torch on the card "
          f"{steps / secs['torch']:.1f}, native {steps / secs['native']:.1f}, torch on the CPU "
          f"{cpu_rate:.1f} ({n_cpu} steps)", flush=True)

    # The full-batch autoreset on the card against the CPU, on one CPU deal.
    B = 8192
    g = torch.Generator().manual_seed(1)
    st_c, _, mask_c = core.reset(B, g, "cpu")
    fresh_c = core.reset(B, g, "cpu")
    fresh_g = (fresh_c[0].map(lambda x: x.to(device)),) + tuple(x.to(device) for x in fresh_c[1:])
    st_g, mask_g = st_c.map(lambda x: x.to(device)), mask_c.to(device)

    def agree(what, pairs):
        for name, x, y in pairs:
            check(torch.equal(x, y.cpu()), f"{what}: {name} on the card differs from the CPU")

    t0, ended = time.perf_counter(), [0, 0]
    for t in range(200):
        a = uniform_legal_action(mask_c, g)
        st_c, out_c, obs_c, mask_c = core.step_autoreset(st_c, a, fresh=fresh_c, mask=mask_c)
        st_g, out_g, obs_g, mask_g = core.step_autoreset(st_g, a.to(device), fresh=fresh_g,
                                                         mask=mask_g)
        agree(f"step_autoreset ply {t}", [(k, v, getattr(st_g, k)) for k, v in st_c.items()]
              + [(k, getattr(out_c, k), getattr(out_g, k)) for k in vars(out_c)]
              + [("obs_next", obs_c, obs_g), ("mask_next", mask_c, mask_g)])
        ended[0] += int(out_c.terminated.sum())
    for t in range(100):  # 200 plies: the CPU side sets this loop's time
        a = uniform_legal_action(mask_c, g)
        st_c, out_c, obs_c, mask_c, done_c = dual.dual_step_autoreset(
            st_c, a, opponents.greedy_v1_policy, fresh=fresh_c)
        st_g, out_g, obs_g, mask_g, done_g = dual.dual_step_autoreset(
            st_g, a.to(device), opponents.greedy_v1_policy, fresh=fresh_g)
        agree(f"dual_step_autoreset turn {t}", [(k, v, getattr(st_g, k)) for k, v in st_c.items()]
              + [(k, getattr(out_c, k), getattr(out_g, k)) for k in vars(out_c)]
              + [("obs_next", obs_c, obs_g), ("mask_next", mask_c, mask_g), ("done", done_c, done_g)])
        ended[1] += int(done_c.sum())
    check(min(ended) > 0, f"the full-batch autoreset ended no game: {ended}")
    print(f"host: core.step_autoreset (200 plies) and dual_step_autoreset (100 turns) on the card "
          f"equal the CPU at B={B} ({ended} games ended) in {time.perf_counter() - t0:.3f} s",
          flush=True)

    # The vector env at 8192 lanes, both autoreset modes, both backends.
    rates = {}
    for backend in ("torch", "native"):
        for mode in ("NextStep", "SameStep"):
            v = SplendaxVectorEnv(B, autoreset_mode=mode, backend=backend, device=device)
            obs, info = v.reset(seed=7)
            pending, spent, terminated = np.zeros(B, bool), 0.0, 0
            for _ in range(200):
                m = info["action_mask"]
                acts = np.where(m.any(1), (rng.rand(B, 45) * m).argmax(1), 0)
                t0 = time.perf_counter()
                obs, r, term, trunc, info = v.step(acts)
                spent += time.perf_counter() - t0
                where = f"vector env ({backend}, {mode})"
                check(obs.min() >= 0 and obs.max() <= 200, f"{where}: obs outside [0, 200]")
                check("illegal_action" not in info or not info["illegal_action"][~pending].any(),
                      f"{where}: a legal action was flagged illegal")
                if mode == "NextStep":
                    check((r[pending] == 0).all() and not term[pending].any()
                          and (obs[pending, 295] == 0).all(),
                          f"{where}: a pending lane did not restart with reward 0")
                    pending = term.copy()
                else:
                    fo = info.get("final_obs")
                    on = np.zeros(B, bool) if fo is None else np.array([x is not None for x in fo])
                    check(np.array_equal(on, term) and (not term.any() or
                                                        np.array_equal(info["_final_obs"], term)),
                          f"{where}: final_obs is not exactly on the terminated lanes")
                terminated += int(term.sum())
            check(terminated > 0, f"vector env ({backend}, {mode}): no game ended")
            rates[f"{backend} {mode}"] = B * 200 / spent
    print(f"host: SplendaxVectorEnv({B}), 200 steps each, env steps/s: "
          + ", ".join(f"{k} {x:.1f}" for k, x in rates.items()), flush=True)

    # From here the host path's launches are counted.
    net_path = os.path.join(ROOT, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz")
    net = ac.import_params_npz(net_path, device=device)
    zero_launches()
    greedy, seen = wrappers.frozen_policy_from(net), []

    def recorded(obs, info):
        a = greedy(obs, info)
        seen.append((obs, info["action_mask"], a))
        return a

    w = wrappers.DualStepSelfPlayWrapper(SplendorEnv(device=device), recorded, random_starts=False)
    t0 = time.perf_counter()
    outcomes = []
    for game in range(4):
        obs, info = w.reset(seed=game)
        for _ in range(300):
            obs, r, term, trunc, info = w.step(recorded(obs, info))
            if term:
                outcomes.append(r)
                break
    dt_wrap = time.perf_counter() - t0
    check(len(outcomes) == 4, "wrapper: a game did not end")
    w64 = [x.double().cpu() for x in ac.kernel_weights(net)]
    obs64 = torch.as_tensor(np.stack([s[0] for s in seen]))
    mask64 = torch.as_tensor(np.stack([s[1] for s in seen]) > 0)
    l64, _ = fac.fused_masked_forward_plain(w64, obs64, mask64, with_value=False)
    top2 = l64.topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    got = torch.tensor([s[2] for s in seen])
    check(bool((got == l64.argmax(-1))[clear].all()),
          "wrapper: a greedy action differs from the float64 plain forward's argmax")
    print(f"host: DualStepSelfPlayWrapper with frozen_policy_from (h768 flagship) played 4 games "
          f"({len(seen)} greedy moves, {int(clear.sum())} off near-ties all equal to the float64 "
          f"argmax; agent rewards {outcomes}) in {dt_wrap:.3f} s", flush=True)

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        game_logger.main(["--policy", "model", "--npz", net_path, "--seed", "3", "--quiet"],
                         device=device)
    check("GAME OVER" in out.getvalue(), "game_logger --policy model: the game did not end")
    print(f"host: game_logger --policy model --seed 3 in {time.perf_counter() - t0:.3f} s: "
          f"{out.getvalue().splitlines()[-1]}", flush=True)

    # The flagship rollout with the full-batch autoreset, then one update.
    cfg = PPOConfig(num_envs=8192, num_steps=64, hidden=768, pool_size=12, p_current=0.25,
                    reset_ring_mult=0, minibatch_size=32768, update_epochs=4, lr=2.5e-4,
                    lr_anneal=True, target_kl=0.02, snapshot_every_updates=16,
                    total_timesteps=2_000_000_000, rng_mode="fast")
    ts = flagship_state(cfg, device)
    ppo.rollout(cfg.replace(num_steps=2), ts)  # warm-up, not kept
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, traj = ppo.rollout(cfg, ts)
    torch.cuda.synchronize()
    full_rates = [cfg.num_steps / (time.perf_counter() - t0)]
    legal = traj.mask.gather(2, traj.action[..., None])[..., 0]
    check(bool((legal | ~traj.mask.any(-1)).all()), "full-batch rollout: an agent action was illegal")
    check(int(traj.done.sum()) > 0 and int(traj.overflow) == 0, "full-batch rollout: no episode")
    lp, _ = fac.fused_masked_forward_plain(ts.pool.slot(ts.pool.pool_size), traj.obs[-1], traj.mask[-1])
    want = torch.log_softmax(lp, -1).gather(1, traj.action[-1][:, None])[:, 0]
    check((want - traj.logp[-1]).abs().max().item() < 1e-4, "full-batch rollout: logp off the plain")
    before = [p.detach().clone() for p in ts.params.parameters()]
    ts, metrics = ppo.update_step(cfg, ts)
    torch.cuda.synchronize()
    launches = read_launches()
    values = {k: v.item() for k, v in metrics.items()}
    check(all(np.isfinite(list(values.values()))), f"full-batch update: metrics {values}")
    check(any(not torch.equal(a, b) for a, b in zip(before, ts.params.parameters())),
          "full-batch update: no parameter moved")
    check(launches["fused_actor_critic"] > 0 and launches["ring_take"] == 0,
          f"host path: launches {launches}")
    # Against the ring rollout on the same state, alternating.
    ring_cfg = cfg.replace(reset_ring_mult=2)
    ring_rates = []
    for c, rates_of in ((ring_cfg, ring_rates), (cfg, full_rates), (ring_cfg, ring_rates)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = ppo.rollout(c, ts)
        torch.cuda.synchronize()
        rates_of.append(c.num_steps / (time.perf_counter() - t0))
    print(f"host: flagship rollout (N={cfg.num_envs}, T={cfg.num_steps}, H={cfg.hidden}) turns/s "
          f"with reset_ring_mult=0 "
          f"{[round(x, 3) for x in full_rates]} against the ring's {[round(x, 3) for x in ring_rates]} "
          f"(alternating: full, ring, full, ring); one update_step with reset_ring_mult=0, metrics "
          f"{values}; host-path launches {launches}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_profile(cfg, ts, n: int = 4, label: str = "profile") -> None:
    """Where a flagship turn's time goes: n turns timed on the host clock,
    then the same under torch.profiler for the device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from splendax_torch.env import ring as ring_lib
    from splendax_torch.selfplay import pool as pool_lib
    from splendax_torch.train import ppo

    pool = pool_lib.set_current(ts.pool, ts.params)
    w = pool.slot(pool.pool_size)
    ring = ring_lib.make_ring(cfg.reset_ring_mult * cfg.num_envs, ts.generator, ts.obs.device,
                              window=cfg.num_envs)
    carry = (ts.env_state, ts.obs, ts.mask, ts.opp_idx, ring, pool)

    def turns(k):
        nonlocal carry
        for _ in range(k):
            st, obs, mask, idx, rg, pl = carry
            t = ppo.rollout_turn(cfg, w, pl, st, obs, mask, idx, rg, generator=ts.generator)
            carry = (t.env_state, t.obs, t.mask, t.opp_idx, t.ring, t.pool)
        torch.cuda.synchronize()

    turns(1)
    t0 = time.perf_counter()
    turns(n)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        turns(n)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    count = sum(e.count for e in kernels) / n
    check(dev_ms > 0, "profile: the profiler saw no device time")
    print(f"{label}: {wall_ms:.3f} ms/turn on the host clock; device busy {dev_ms:.3f} ms/turn "
          f"in {count:.0f} kernel launches ({100 * dev_ms / wall_ms:.1f}% busy)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/turn  {e.count / n:6.1f}x  "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "splendax_torch", "csrc")):
        print("chip_smoke: the splendax_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    device = torch.device("cuda", 0)

    from splendax_torch.ops import _build

    secs, reports = _build.timed_build()
    print(f"build: {secs:.2f} s for {sorted(reports)}", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    phase_engine_agreement(device)
    phase_env(device)
    launches, cfg, ts = phase_rollout(device)
    by_path = {"rollout": launches, "update": phase_update(device), "train": phase_train(device)}
    zero_launches()
    phase_search(device)
    by_path["search"] = read_launches()
    by_path["league"], cfg_league, ts_league = phase_league(device)
    phase_parity(device)
    zero_launches()
    phase_cli(device)
    by_path["cli"] = read_launches()
    by_path["host"] = phase_host(device)
    check(all(by_path[p]["fused_actor_critic"] > 0 for p in ("search", "cli", "host")),
          f"a search or host path did not launch kernel A: {by_path}")
    kern = phase_kernels(device)
    phase_profile(cfg, ts)
    phase_profile(cfg_league, ts_league, label="profile (league slot)")

    meta = {
        "fused_actor_critic": ("splendax_torch/csrc/fused_actor_critic.cu",
                               "splendax/ops/fused_actor_critic.py:37"),
        "ring_take": ("splendax_torch/csrc/ring_take.cu", "splendax/ops/ring_take.py:38"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        k = kern[name]
        # launches: the sum over the driven paths, each counted from 0.
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=sum(p[name] for p in by_path.values()),
                         launches_by_path={path: p[name] for path, p in by_path.items()}, **k))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

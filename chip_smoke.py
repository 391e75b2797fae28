#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`splendax_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build the CUDA kernels from `splendax_torch/csrc` (one nvcc per source,
     in parallel) and print the build seconds;
  2. check the engine on the card against the engine on the CPU, ply by
     ply, on identical actions and ring;
  3. the benchmark, `python -m splendax_torch.bench`, in seven processes of
     its own: the env workload at `bench.py`'s shape (B=32768 games, uniform
     random legal actions, ring autoreset with a 4096-row window, 400 steps a
     call, best of 5), the league recipe's `update_step` without and with
     its search slot (the committed agent run's update 3,812 with a full
     pool, best of 3, each from the state its warm-up left), and the search
     workload for each of `scripts/time_search.py`'s bots (mc, gumbel, uct,
     greedy over the h768 net against its greedy policy) cut to 16 games and
     one timed eval after the warm-up.  Each JSON line is checked against the
     bench's contract (keys, shape, no ring overflow, kernel B 6 x 400
     launches, every rep all 64 optimizer steps, no illegal move, kernel A in
     the modes its B derive) and printed; each process's launch counts are
     its path's;
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
     every batch and window size that the driven phases give it, and time the
     kernel, the plain version and one PyTorch library call for the
     same function at the main path's shapes, on the device clock (the
     summed kernel time under torch.profiler).  Kernel A takes its wgmma
     route at H <= 768 (held at H = 256, 512 and 768 on the committed nets,
     its tile and cluster modes bit for bit against each other) and its wide route above (held at H = 1024, 1280
     and 2048 on random weights, B = 1 to 8192 with the wide paths' 16, 512
     and 1024, obs of 4097, its pass and half modes bit for bit against each
     other); at each main-path shape both modes of the wgmma kernel, alone
     and with their prep, the plain forward and the addmm chain are timed,
     and so are both modes of the wide route at the wide paths' shapes (H =
     1024, B = 16, 50, 100, 256, 1024 and 8192; H = 1280, B = 512 and 8192)
     beside the same yardsticks.
     "With the prep" is a forward on a plain list of weights; the paths' handles
     pay the prep once per weight version.  Its prep kernel equals the
     plain preparation bit for bit at H = 64, 256, 768, 769, 1024, 1280 and
     2048, with and without the critic, and is timed at H = 768, 1024 and
     1280.  The step kernel's token return equals the plain
     version on fuzzed hands at B = 8192 and 36,000 and on 8192 games in
     play.  The ply's kernels (`ops/engine_ply`) equal the plain
     functions at the static league cell's calls (the agent's ply, a
     playout step, the search's children; the reset, the lanes, the turn's
     observation) and are timed beside them;
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
     Then four of its turns under the profiler, as in 8.  Then two of its
     updates on the pool's prepared-weight handles from the full pool, the
     first pushing a snapshot, the second from the bench's deep copy of
     the state, then a checkpoint restore: every forward on a handle
     equals the same forward on freshly prepared weights bit for bit;
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
     the "host" path;
 14. search distillation: `python -m splendax_torch.train.distill` through
     `main` on the committed recipe (runs/distill_h768/results.json: r16 h4,
     sample 20 plies, c 20, gumbel target) cut to 256 games, 2 epochs and a
     gate of 64 games a seat, its files and dataset checked and each phase
     timed; one generation chunk at the recipe's 1024 games (737,280 playout
     lanes), its seconds a ply, peak memory and 6 kernel A launches a ply
     asserted; the loop on the card against the CPU on the same draws;
 15. `ppo_generic` on SplendaxTorch-v0 on the card, 2 updates;
 16. parallel: two gloo ranks sharing the card run the league recipe's
     update (without the slot) at dp=2 (64 turns) and at tp=2 (8 turns)
     from the flagship state, each held against one process's update from
     the same state: the rollout rows bit for bit, the first minibatch's
     loss and gradients within rtol 1e-4, the optimizer steps the KL stop
     leaves; kernel A on two 4096-row halves against the B=8192 call; the
     whole-weight gather timed; `dryrun_multichip(4)` on the card; the
     scaling bench at 4096 games a rank over 1 and 2 ranks.  The ranks zero
     their launch counters before the measured update and return them.
     Kernel A on 4096 + 4096 and 1000 + 7192 rows equals the B=8192 call
     bit for bit;
 17. `train.train` at hidden 1024 (one update of 1024 x 8 with an eval at
     step 0) and at hidden 1280 (one update of 512 x 8): kernel A's wide
     route on a driven path, in both its modes;
 18. the committed h1024 net (`runs/ppo_splendor_2b_h1024`) greedy against
     the basic heuristic over 256 games, through the wide route; every
     forward it made is then held against the float64 and float32 plain
     forwards on the rows it was given, and its other mode bit for bit;
 19. the all-agents Elo ladder (`python -m splendax_torch.eval.ladder`
     through `main`, with its search rows) on a cut of the committed ladder
     `runs/elo_ladder.json`: the other pairs given as already played, it
     plays h256 vs basic, h512 vs h256, h768 vs noble, h1024 vs h768 (32
     games a seat order) and mc over the h768 net vs basic (8): every
     committed width and both routes of kernel A.  Each forward is held as
     in 18 and against the route its width gives, save that at an output
     where it lies more than F32_PLAIN_SLACK from the float32 forward it
     must be the nearer of the two to float64 (`hold_forwards`); each pair's
     z against the committed pair must be within 4.  The kernel phase times the
     ladder's h512 forward (B = 100, cluster mode) beside addmm, and the
     wide route at H = 1024, B = 50 and 100 (half mode);
 20. the replay of the committed duels (`python -m
     splendax_torch.eval.duel_replay` through `main`) on three of its
     entries at 16 games a seat order: uct against gumbel over the h768 net,
     the censored Gumbel search at k12 against the censored flat MC, and the
     s43 league nets (H = 256) against each other.  Each forward is held as
     in 19 and each file's z against its committed file must be within 4.

Every driven path at H <= 768 (4 to 16) must launch kernel A on its wgmma
route only, in the mode its B derives (`wgmma_mode`: cluster mode up to
CLUSTER_MAX_ROWS rows, tile mode above), the cluster mode on the pool
slots, the eval suite, the root prior and the host policies; paths 17 and
18 on the wide route only, in the mode its B derives (`wide_mode`); paths 19
and 20 on each net's own route.  On
every path the weight preparations must equal those its forwards' weights
call for (`bench.needs_preparation`): one for each forward on a plain list,
one for each written weight version on a `PreparedWeights` handle (the
pool's slots, the eval and host policies, the search contexts).

Phases 9 to 20 run after phase 6 and before phase 7, so the host-clock
rates (phases 3 to 6 and 9 to 20) are taken before the first
torch.profiler session of the process, so that no profiler state is left
behind in them.  A profile of one distillation ply at 737,280 lanes comes
last.

Prints the card's name and power limit first, the bench's seven lines in
phase 3, a JSON line with each kernel's numbers second to last, and
`{"ok": true, "device": ...}` last.
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
if not os.path.isdir(os.path.join(ROOT, "splendax_torch", "csrc")):
    sys.exit("chip_smoke: the splendax_torch package is not beside this script")
from splendax_torch.bench import (  # noqa: E402  (after the check above)
    check_route, derived_modes, flagship_state, league_config, LEARNER_PHASES, read_launches,
    restore_state, save_state, timed_calls, zero_launches,
)
from splendax_torch.ops import _build  # noqa: E402

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 494.7e12  # TF32 tensor cores, dense, H100 SXM data sheet
# Kernel A against the plain float32 forward, in units of the rtol/atol 1e-5
# tolerance: that forward is itself up to 1.35x the tolerance off the float64
# one on the committed nets' checked rows, and the kernel read up to 1.44x off
# it on an H100 (PERF.md).
F32_PLAIN_SLACK = 1.5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def profiled_kernels(run, min_launches: int = 1, tries: int = 3) -> list:
    """The device kernels' torch.profiler averages over one call of `run`,
    from the first of up to `tries` sessions that sees device time in at
    least `min_launches` kernel launches; [] if none does.  On the card a
    late session of a long run once saw no kernel, and another saw too few
    (0.0001 ms for five kernels whose bound is 0.0024 ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if (sum(e.self_device_time_total for e in kernels) > 0
                and sum(e.count for e in kernels) >= min_launches):
            return kernels
    return []


def device_ms(fn, n: int, warmup: int = 3, per_call: int = 1) -> tuple[float, float]:
    """(ms, host ms) per call of `fn`.  ms is the summed device time of
    every kernel that n back-to-back calls launch, from torch.profiler
    (`profiled_kernels`, which needs the `per_call` launches of each of the
    n calls), over n; where no profiler session sees them, the time between
    two CUDA events around n calls, over n, and a line says so.  host ms is
    the wall time of n calls ending in a synchronize, over n."""
    import torch

    def calls():
        for _ in range(n):
            fn()

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = profiled_kernels(calls, min_launches=n * per_call)
    if kernels:
        return sum(e.self_device_time_total for e in kernels) / 1e3 / n, host_ms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    calls()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    check(ms > 0, "neither the profiler nor CUDA events timed the kernel")
    print(f"  (no profiler session saw device time: {ms:.4f} ms from CUDA events)", flush=True)
    return ms, host_ms


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


def bound_a(B: int, H: int, with_value: bool, l1_products: int,
            actor: bool = True) -> tuple[float, str, float]:
    """Kernel A's least time: (ms on its own route, what bounds it, ms on the
    f32 CUDA cores).  Its route takes `l1_products` TF32 products for each
    f32 one of layer 1 (2 where every obs is exact in TF32, else 3) and 3
    for every other tensor-core product; the one-column value head is f32 on
    the CUDA cores.  Bytes: obs, mask and weights read once, outputs written
    once.  `actor` False: the critic alone, which reads no mask."""
    heads = int(actor) + int(with_value)
    layer1 = 2 * B * 297 * H * heads
    layer2 = 2 * B * H * H * heads
    logits = 2 * B * H * 45 if actor else 0
    value = 2 * B * H if with_value else 0
    t_ops = ((l1_products * layer1 + 3 * (layer2 + logits)) / H100_TF32_FLOPS
             + value / H100_F32_FLOPS)
    t_f32 = (layer1 + layer2 + logits + value) / H100_F32_FLOPS
    n_weights = (heads * (297 * H + H * H + 2 * H) + (45 * H + 45 if actor else 0)
                 + (H + 1 if with_value else 0))
    nbytes = (4 * B * 297 + (B * 45 if actor else 0) + 4 * n_weights
              + 4 * B * ((45 if actor else 0) + (1 if with_value else 0)))
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
    # closer than that to the exact forward on these nets (up to 1.35x the
    # tolerance on the rows below), so against it the kernel is held within
    # F32_PLAIN_SLACK times the tolerance; both shares are printed.
    err_a = 0.0
    # 8192, 2048 and 3072 are the league rollout's shapes, 256 its eval's;
    # 1024 and 64 are the train phase's agent and eval forwards.  The league
    # slot's search runs 32768 playout lanes (with and without value) and a
    # root prior on 1024 rows; the search phase and the eval CLI give 32,
    # 24576 (256 games x 96 Gumbel lanes) and 92160 (256 x 45 x 8 MC lanes).
    # 4096 is a dp=2 rank's agent forward and bootstrap value; 512 a full
    # pool's snapshot slot (12 snapshots share 3/4 of 8192 rows).
    # 100 and 50 are the all-agents ladder's games a seat order (nets and
    # search bots), 8 and 32 its smoke cut's.  The duel replay's nets and
    # greedy bots play 100, 200 and 400 games (400 the league evals' H=256
    # nets), its smoke cut 16 (its search lanes 1536, 3072 and 5760).
    checked_b = (1, 8, 16, 17, 32, 50, 64, 100, 200, 256, 257, 400, 512, 1024, 1536, 2048, 3072,
                 4096, 5760, 8192, 24576, 32768, 92160)
    # The duel replay's search lanes over the h768 net (its full run on the
    # card), on rows of their own at that width: Gumbel m16 k6 at 100, 200
    # and 400 games (9600, 19200, 38400; k12 at 100 games, 19200) and flat
    # MC r8 (36000, 72000, 144000).
    search_b = (9600, 19200, 36000, 38400, 72000, 144000)
    # Distillation's teacher, at the width it runs (H=768, the recipe's
    # source net), on rows of their own: 184320 lanes (256 games x 45 x 16
    # rollouts, the distill CLI phase) and 737280 (the recipe's 1024-game
    # chunk).  At H=256 the float32 plain version is itself up to 1.6x the
    # tolerance off float64 on 737280 such rows, so the float32 bound holds
    # for no kernel there (PERF.md).
    distill_b = (184320, 737280)

    def share(got, want):
        """max |got - want| as a share of the rtol/atol 1e-5 tolerance."""
        got, want = got.double(), want.double()
        return ((got - want).abs() / (1e-5 + 1e-5 * want.abs())).max().item()

    modes = tuple(fac.launches_by_mode)

    def critic_alone(w, obs, value, r, route_modes, where):
        """The critic alone as the path runs it (`fused_value_forward`) and
        in each of the route's modes forced: one launch each, counted as the
        critic's, each equal to the two-head call's `value` bit for bit."""
        n0 = fac.critic_launches
        got = [fac.fused_value_forward(w, obs)] + [
            fac._launch(r, w, obs, None, True, mode=m)[1] for m in route_modes]
        check(fac.critic_launches == n0 + 1 + len(route_modes)
              and all(torch.equal(g, value) for g in got),
              f"kernel A's critic alone differs from the two-head value at {where}")

    def each_mode(w, obs, mask, with_value, where):
        """The forward as the path runs it, after checking that each mode,
        forced on the same rows, gives it bit for bit."""
        got = fac.fused_masked_forward(w, obs, mask, with_value=with_value)
        for m in modes:
            forced = fac._launch("wgmma", w, obs, mask, with_value, mode=m)
            check(all(a is None or torch.equal(a, b) for a, b in zip(got, forced)),
                  f"kernel A's {m} mode differs from the path's forward at {where}")
        return got

    for H, src in ((256, "runs/ppo_splendor_2b/ppo_splendor_params.npz"),
                   (512, "runs/ppo_splendor_2b_h512/ppo_splendor_params.npz"),
                   (768, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz")):
        w = ac.kernel_weights(ac.import_params_npz(os.path.join(ROOT, src), device=device))
        w64 = [t.double() for t in w]
        check(w[0].shape[1] == H, f"{src} has hidden {w[0].shape[1]}, expected {H}")
        obs_all, mask_all = realistic_obs(max(checked_b), 30, seed=H, device=device)
        rows = [(B, obs_all, mask_all) for B in checked_b]
        if H == 768:
            obs_big, mask_big = realistic_obs(max(distill_b), 30, seed=H, device=device)
            rows += [(B, obs_big, mask_big) for B in search_b + distill_b]
        err_h, shares = 0.0, [0.0, 0.0, 0.0]
        before = dict(fac.launches_by_route)
        for B, obs_src, mask_src in rows:
            obs, mask = obs_src[:B].contiguous(), mask_src[:B].contiguous()
            for with_value in (True, False):
                where = f"H={H} B={B} value={with_value}"
                outs = [each_mode(w, obs, mask, with_value, where),
                        fac.fused_masked_forward_plain(w, obs, mask, with_value=with_value),
                        fac.fused_masked_forward_plain(w64, obs, mask, with_value=with_value)]
                torch.cuda.synchronize()
                for got, f32, ref in zip(*outs):
                    if got is None:
                        continue
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
                if with_value:
                    critic_alone(w, obs, outs[0][1], "wgmma", modes, where)
        # Distillation's root prior: the raw actor head, through an all-true
        # mask, at the CLI phase's 256 games and the recipe's 1024.
        for B in (256, 1024):
            every = torch.ones((B, 45), dtype=torch.bool, device=device)
            got = each_mode(w, obs_all[:B].contiguous(), every, False, f"root prior B={B}")[0]
            ref = fac.fused_masked_forward_plain(w64, obs_all[:B].contiguous(), every, False)[0]
            check(torch.allclose(got.double(), ref, rtol=1e-5, atol=1e-5)
                  and (got > -1e8).all().item(),
                  f"kernel A's root prior (all-true mask) at H={H} B={B}: "
                  f"{share(got, ref):.3f} of the tolerance")
        # Obs past 2048 are not exact in TF32: their tiles take layer 1's
        # third product (lo.hi), the others skip it.
        for B in (1, 8192):
            obs = obs_all[:B].clone()
            obs[max(B - 100, 0)::9, 0] = 4097
            mask = mask_all[:B].contiguous()
            for with_value in (True, False):
                got = each_mode(w, obs, mask, with_value, f"obs of 4097 B={B}")
                if with_value:
                    critic_alone(w, obs, got[1], "wgmma", modes, f"obs of 4097 B={B}")
                ref = fac.fused_masked_forward_plain(w64, obs, mask, with_value)
                for g, r in zip(got, ref):
                    if g is not None:
                        check(torch.isfinite(g).all().item()
                              and torch.allclose(g.double(), r, rtol=1e-5, atol=1e-5),
                              f"kernel A with obs of 4097 at H={H} B={B} value={with_value}: "
                              f"{share(g, r):.3f} of the tolerance")
                        shares[0] = max(shares[0], share(g, r))
        check(all(fac.launches_by_route[r] == before[r] for r in before if r != "wgmma")
              and fac.launches_by_route["wgmma"] > before["wgmma"],
              f"kernel A at H={H} left the wgmma route: {fac.launches_by_route}")
        # The prep kernel on the committed net against its plain version, bit
        # for bit (the actor's half alone without the critic: the kernel
        # leaves the rest unwritten); every other width below.
        for with_value in (True, False):
            n = len(fac.prepare_weights_plain(w)) if with_value else fac.prepared_layout(H)[2][0]
            check(torch.equal(fac.prepare_weights(w, with_value)[:n],
                              fac.prepare_weights_plain(w, with_value)[:n]),
                  f"the prep kernel differs from its plain version at H={H} value={with_value}")
        err_a = max(err_a, err_h)
        print(f"kernel A H={H}: max abs err {err_h:.3g} vs the float64 plain version, "
              f"{shares[0]:.3f} of the rtol/atol 1e-5 tolerance; the float32 plain version: "
              f"{shares[1]:.3f} of it vs float64; kernel vs float32 plain: {shares[2]:.3f} "
              f"(at most {F32_PLAIN_SLACK}; B in {[r[0] for r in rows]}, with and without value, "
              f"and B in (1, 8192) with obs of 4097; wgmma route, its modes {modes} bit-equal "
              f"on every row, the critic alone equal to the two-head value in each; the prep "
              f"kernel equals its plain version bit for bit)", flush=True)
    # The wide route (every H > 768), at H = 1024, 1280 and 2048 on seeded
    # random weights and engine obs, held the same way, its two modes bit
    # for bit; the last case puts obs of 4097 (not exact in TF32) into some
    # of B = 8192's tiles.  B = 16 is the wide trains' eval, 512 the H=1280
    # train's rollout and bootstrap, 1024 the H=1024 train's.
    def random_weights(H):
        rng = np.random.RandomState(H)
        out = []
        for n_out in (45, 1):
            for fi, fo in ((297, H), (H, H), (H, n_out)):
                for shape in ((fi, fo), (fo,)):
                    out.append(torch.as_tensor(
                        (rng.uniform(-1, 1, shape) / np.sqrt(fi)).astype(np.float32),
                        device=device))
        return out

    # The prep kernel against the plain preparation bit for bit at every
    # width the routes' paths and tests give it, ragged (769) and 16-byte
    # aligned, with and without the critic; and on a weight 4 bytes off
    # 16-byte alignment (its 4-byte path).
    prep_widths = (64, 256, 768, 769, 1024, 1280, 2048)
    for H_p in prep_widths:
        w_p = random_weights(H_p)
        if H_p == 768:
            w_p[2] = torch.empty(H_p * H_p + 1, device=device)[1:].view(H_p, H_p).copy_(w_p[2])
        for with_value in (True, False):
            want = fac.prepare_weights_plain(w_p, with_value)
            n = want.numel() if with_value else fac.prepared_layout(H_p)[2][0]
            check(torch.equal(fac.prepare_weights(w_p, with_value)[:n], want[:n]),
                  f"the prep kernel differs from its plain version at H={H_p} value={with_value}")
    print(f"kernel A prep: the kernel equals the plain preparation bit for bit at "
          f"H in {prep_widths}, with and without the critic (H=768 with aw1 off 16-byte "
          f"alignment)", flush=True)

    wide_modes_ = tuple(fac.launches_by_wide_mode)

    def wide_modes(w, obs, mask, with_value, where):
        """The wide forward as the path runs it, after checking that each
        mode, forced on the same rows, gives it bit for bit."""
        got = fac.fused_masked_forward(w, obs, mask, with_value=with_value)
        for m in wide_modes_:
            forced = fac._launch("wide", w, obs, mask, with_value, mode=m)
            check(all(a is None or torch.equal(a, b) for a, b in zip(got, forced)),
                  f"kernel A's wide {m} mode differs from the path's forward at {where}")
        return got

    # 100 and 32 are the all-agents ladder's games a seat order for the
    # h1024 net and its smoke cut's.
    wide_b = (1, 16, 32, 100, 256, 257, 512, 1024, 4096, 4097, 8192)
    wide_cases = [(B, False) for B in wide_b] + [(8192, True)]
    err_wide, share_wide, share_wide32, n_wide = 0.0, 0.0, 0.0, 0
    before = dict(fac.launches_by_route)
    for H in (1024, 1280, 2048):
        w_h = random_weights(H)
        w64_h = [t.double() for t in w_h]
        for B, big in wide_cases:
            obs, mask = obs_all[:B].clone(), mask_all[:B].contiguous()
            if big:
                obs[B - 100::9, 0] = 4097
                obs[0, 5] = 4097
            for with_value in (True, False):
                where = f"H={H} B={B} value={with_value}" + (" obs of 4097" if big else "")
                outs = [wide_modes(w_h, obs, mask, with_value, where),
                        fac.fused_masked_forward_plain(w_h, obs, mask, with_value),
                        fac.fused_masked_forward_plain(w64_h, obs, mask, with_value)]
                n_wide += 1 + len(wide_modes_)
                if with_value:
                    critic_alone(w_h, obs, outs[0][1], "wide", wide_modes_, where)
                    n_wide += 1 + len(wide_modes_)
                torch.cuda.synchronize()
                for got, f32, ref in zip(*outs):
                    if got is None:
                        continue
                    check(torch.isfinite(got).all().item()
                          and torch.allclose(got.double(), ref, rtol=1e-5, atol=1e-5)
                          and share(got, f32) <= F32_PLAIN_SLACK,
                          f"kernel A's wide route at {where}: {share(got, ref):.3f} of the "
                          f"tolerance vs float64, {share(got, f32):.3f} vs float32")
                    err_wide = max(err_wide, (got.double() - ref).abs().max().item())
                    share_wide = max(share_wide, share(got, ref))
                    share_wide32 = max(share_wide32, share(got, f32))
                check((outs[0][0][0] > -1e8).all().item(),
                      f"kernel A's wide route masked a row with no legal action at {where}")
    check(fac.launches_by_route["wgmma"] == before["wgmma"]
          and fac.launches_by_route["wide"] == before["wide"] + n_wide,
          f"kernel A at H > 768 left the wide route: {fac.launches_by_route}")
    print(f"kernel A H=1024, 1280, 2048 (wide route, random weights): max abs err {err_wide:.3g} "
          f"vs the float64 plain version, {share_wide:.3f} of the tolerance; kernel vs float32 "
          f"plain {share_wide32:.3f} (at most {F32_PLAIN_SLACK}); B in {wide_b} and 8192 with obs "
          f"of 4097, with and without value; modes {wide_modes_} bit-equal on every row, the "
          f"critic alone equal to the two-head value in each", flush=True)
    # Times at H = 768: the agent forward (B = 8192, with value), the pool
    # slots' forwards (B = 2048, 3072, no value; 512, a full pool's snapshot
    # slot) and the eval suite's greedy forward (B = 256, no value), then the
    # league slot's search: its leaves' lanes (B = 32768, with value), its
    # playout moves (B = 32768, no value) and its root prior (B = 1024, no
    # value), then the host policies' greedy move (B = 1, no value), then
    # distillation's teacher: its leaves' lanes (with value) and playout
    # moves (no value) at 737280 lanes (the recipe's chunk) and 184320 (the
    # CLI phase's; its root prior is the B = 1024 row above), then a dp=2
    # rank's agent (B = 4096), then the duel replay's search lanes at 100
    # games, with and without value: flat MC r8 (B = 36000) and Gumbel m16
    # k6 (B = 9600); each beside the addmm chain for the same rows and heads.
    # (The leaves and the bootstraps take the critic alone, timed below.)
    # Both modes of the wgmma route are timed at every shape, each alone
    # and, up to B = 8192, with its prep.
    H = 768
    w = ac.kernel_weights(ac.import_params_npz(os.path.join(ROOT, FLAGSHIP), device=device))
    l1_products = 2 if obs_all.abs().max().item() <= 2048 else 3
    clusters = fac.max_clusters(H)
    print(f"kernel A H={H}: cluster mode runs clusters of {fac.column_groups(H)} blocks, "
          f"{clusters} resident at once ({clusters * fac.column_groups(H)} blocks)", flush=True)
    shapes = []
    for B, with_value in ((8192, True), (2048, False), (3072, False), (256, False), (512, False),
                          (32768, True), (32768, False), (1024, False), (1, False),
                          (737280, True), (737280, False), (184320, True), (184320, False),
                          (4096, True), (4096, False), (36000, True), (36000, False),
                          (9600, True), (9600, False)):
        obs_src, mask_src = (obs_big, mask_big) if B in distill_b else (obs_all, mask_all)
        obs, mask = obs_src[:B].contiguous(), mask_src[:B].contiguous()
        x32 = obs.to(torch.float32)

        def addmm_chain(x32=x32, heads=(0, 6) if with_value else (0,)):
            for o in heads:
                h = torch.tanh(torch.addmm(w[o + 1], x32, w[o]))
                h = torch.tanh(torch.addmm(w[o + 3], h, w[o + 2]))
                torch.addmm(w[o + 5], h, w[o + 4])

        n = 20 if B <= 32768 else 5
        prepared = fac.prepare_weights(w, with_value)
        # The wgmma route on a plain list (prep + kernel, in the mode B
        # derives; a path's handle pays the prep once per weight version),
        # each mode's kernel alone and (up to B = 8192) the other mode with
        # its prep, the plain forward and the addmm chain.
        mode = fac.wgmma_mode(B, H)
        route_ms, host_ms = device_ms(lambda: fac.fused_masked_forward(w, obs, mask, with_value), n,
                                      per_call=2)
        mode_ms = {m: device_ms(lambda: fac._launch("wgmma", w, obs, mask, with_value, prepared,
                                                    mode=m), n)[0] for m in modes}
        prep_ms = {m: route_ms if m == mode else device_ms(
            lambda: fac._launch("wgmma", w, obs, mask, with_value, mode=m), n, per_call=2)[0]
            for m in modes if m == mode or B <= 8192}
        plain_ms = device_ms(lambda: fac.fused_masked_forward_plain(w, obs, mask, with_value), n)[0]
        library_ms = device_ms(addmm_chain, n)[0]
        bound_ms, bound_by, bound_f32_ms = bound_a(B, H, with_value, l1_products)
        shapes.append(dict(B=B, with_value=with_value, mode=mode, ms=mode_ms[mode],
                           route_ms=route_ms, mode_ms=mode_ms, mode_prep_ms=prep_ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by, bound_f32_ms=bound_f32_ms,
                           host_ms=host_ms))
        print(f"kernel A B={B} H={H} value={with_value}: wgmma kernel "
              + ", ".join(f"{m} {mode_ms[m]:.4f}" for m in modes) + " ms; with its prep "
              + ", ".join(f"{m} {t:.4f}" for m, t in prep_ms.items()) + f" ms (the path: "
              f"{mode}); plain {plain_ms:.4f} ms, addmm "
              f"chain {library_ms:.4f} ms (device clock); bound {bound_ms:.4f} ms by {bound_by} "
              f"(3xTF32, layer 1 in {l1_products} products), {bound_f32_ms:.4f} ms on f32 CUDA "
              f"cores; host {host_ms:.4f} ms per call", flush=True)
    # Each mode's row at a shape that the path runs in it: the agent forward
    # (B = 8192 with value) in tile mode, a pool slot (B = 2048) in cluster
    # mode, unless their B derive the other mode.
    for m, B0 in (("tile", 8192), ("cluster", 2048)):
        row = next((r for r in shapes if r["mode"] == m and r["B"] == B0), None) or next(
            r for r in shapes if r["mode"] == m)
        results["fused_actor_critic_" + m] = dict(
            mode=m, max_abs_err=err_a, shape=dict(B=row["B"], with_value=row["with_value"]),
            ms=row["mode_ms"][m], route_ms=row["mode_prep_ms"][m],
            **{k: row[k] for k in ("plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "bound_f32_ms", "host_ms")},
            bound_peak="TF32 tensor cores (3xTF32), 494.7 TFLOP/s",
            checked_against="plain version in float64, rtol/atol 1e-5; the other mode bit for bit",
            by_shape=shapes if m == "tile" else "as fused_actor_critic_tile")

    # The critic alone (`fused_value_forward`: the search's leaves and the
    # bootstrap) at the league slot's leaves (B = 32768) and the eval's
    # Gumbel lanes (B = 9600), H = 768: the kernel alone on prepared weights
    # in the mode B derives (the paths' handles), on a plain list with its
    # prep, the plain version and the critic's addmm chain; beside the
    # two-head call's kernel on the same rows, timed above.
    critics = []
    for B in (32768, 9600):
        obs = obs_all[:B].contiguous()
        x32 = obs.to(torch.float32)
        prepared = fac.prepare_weights(w, True)
        mode = fac.wgmma_mode(B, H)
        ms = device_ms(lambda: fac._launch("wgmma", w, obs, None, True, prepared), 20)[0]
        route_ms, host_ms = device_ms(lambda: fac.fused_value_forward(w, obs), 20, per_call=2)
        plain_ms = device_ms(lambda: fac.fused_value_forward_plain(w, obs), 20)[0]

        def addmm_critic(x32=x32):
            h = torch.tanh(torch.addmm(w[7], x32, w[6]))
            h = torch.tanh(torch.addmm(w[9], h, w[8]))
            torch.addmm(w[11], h, w[10])

        library_ms = device_ms(addmm_critic, 20)[0]
        both_ms = next(r for r in shapes if r["B"] == B and r["with_value"])["mode_ms"][mode]
        err = (fac.fused_value_forward(w, obs).double()
               - fac.fused_value_forward_plain([t.double() for t in w], obs)).abs().max().item()
        bound_ms, bound_by, bound_f32_ms = bound_a(B, H, True, l1_products, actor=False)
        critics.append(dict(B=B, mode=mode, ms=ms, route_ms=route_ms, both_heads_ms=both_ms,
                            plain_ms=plain_ms, library_ms=library_ms, max_abs_err=err,
                            bound_ms=bound_ms, bound_by=bound_by, bound_f32_ms=bound_f32_ms,
                            host_ms=host_ms))
        print(f"kernel A critic alone B={B} H={H} ({mode} mode): {ms:.4f} ms, with its prep "
              f"{route_ms:.4f} ms; both heads {both_ms:.4f} ms ({ms / both_ms:.3f} of it); "
              f"plain {plain_ms:.4f} ms, addmm chain {library_ms:.4f} ms (device clock); bound "
              f"{bound_ms:.4f} ms by {bound_by}, {bound_f32_ms:.4f} ms on f32 CUDA cores; max "
              f"abs err {err:.3g} vs float64; host {host_ms:.4f} ms per call", flush=True)
    results["fused_actor_critic_critic_only"] = dict(
        mode=critics[0]["mode"], max_abs_err=max(r["max_abs_err"] for r in critics),
        shape=dict(B=critics[0]["B"], with_value=True, actor=False),
        **{k: critics[0][k] for k in ("ms", "route_ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "bound_f32_ms", "host_ms")},
        bound_peak="TF32 tensor cores (3xTF32), 494.7 TFLOP/s",
        checked_against="the two-head call's value bit for bit in every mode; plain version in "
                        "float64, rtol/atol 1e-5",
        by_shape=critics)

    # Greedy forwards of the committed nets on prepared handles, as the paths
    # run them, no value, in the mode B derives: the all-agents ladder's h512
    # net at B = 100 (its games a seat order) and the duel replay's league
    # evals, an H=256 net at B = 400; each mode alone, the plain forward and
    # the addmm chain beside it.
    for key, H_l, B, src in (
            ("ladder_h512", 512, 100, "runs/ppo_splendor_2b_h512/ppo_splendor_params.npz"),
            ("replay_h256", 256, 400,
             "runs/ppo_splendor_500m_search_static_s43/ppo_splendor_params.npz")):
        w_l = ac.kernel_weights(ac.import_params_npz(os.path.join(ROOT, src), device=device))
        check(w_l[0].shape[1] == H_l, f"{src} has hidden {w_l[0].shape[1]}, expected {H_l}")
        obs, mask = obs_all[:B].contiguous(), mask_all[:B].contiguous()
        x32 = obs.to(torch.float32)
        handle = fac.PreparedWeights(w_l)
        fac.fused_masked_forward(handle, obs, mask, False)  # its one preparation
        prepared = fac.prepare_weights(w_l, False)
        ms, host_ms = device_ms(lambda: fac.fused_masked_forward(handle, obs, mask, False), 20)
        mode_ms = {m: device_ms(lambda: fac._launch("wgmma", w_l, obs, mask, False, prepared,
                                                    mode=m), 20)[0] for m in modes}
        plain_ms = device_ms(lambda: fac.fused_masked_forward_plain(w_l, obs, mask, False), 20)[0]

        def addmm_actor(w_l=w_l, x32=x32):
            h = torch.tanh(torch.addmm(w_l[1], x32, w_l[0]))
            h = torch.tanh(torch.addmm(w_l[3], h, w_l[2]))
            torch.addmm(w_l[5], h, w_l[4])

        library_ms = device_ms(addmm_actor, 20)[0]
        bound_ms, bound_by, bound_f32_ms = bound_a(B, H_l, False, l1_products)
        row = dict(B=B, H=H_l, with_value=False, mode=fac.wgmma_mode(B, H_l), ms=ms,
                   mode_ms=mode_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bound_f32_ms=bound_f32_ms,
                   host_ms=host_ms)
        results["fused_actor_critic_cluster"][key] = row
        print(f"kernel A B={B} H={H_l} value=False ({key} on its handle, the path: "
              f"{row['mode']}): {ms:.4f} ms; each mode alone "
              + ", ".join(f"{m} {t:.4f}" for m, t in mode_ms.items()) + f" ms; plain "
              f"{plain_ms:.4f} ms, addmm chain {library_ms:.4f} ms (device clock); bound "
              f"{bound_ms:.4f} ms by {bound_by}, {bound_f32_ms:.4f} ms on f32 CUDA cores; host "
              f"{host_ms:.4f} ms per call", flush=True)

    # The prep kernel at H = 768, 1024 and 1280, with and without the
    # critic: its bytes bound reads the first two layers' weights once and writes
    # each prepared matrix (hi and lo, [2, HP, KP]) once.
    preps = []
    for H_p in (768, 1024, 1280):
        w_p = w if H_p == H else random_weights(H_p)
        for with_value in (True, False):
            heads = 2 if with_value else 1
            written = sum(2 * hp * kp for _, hp, kp in fac.prepared_layout(H_p)[:2 * heads])
            nbytes = 4 * (heads * (297 + H_p) * H_p + written)
            ms, host_ms = device_ms(lambda: fac.prepare_weights(w_p, with_value), 20)
            plain_ms = device_ms(lambda: fac.prepare_weights_plain(w_p, with_value), 20)[0]
            preps.append(dict(H=H_p, with_value=with_value, ms=ms,
                              plain_ms=plain_ms, library_ms=None,
                              bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                              host_ms=host_ms))
            print(f"kernel A prep H={H_p} value={with_value}: {ms:.5f} ms, "
                  f"plain {plain_ms:.5f} ms; bound "
                  f"{preps[-1]['bound_ms']:.5f} ms by bytes ({nbytes} bytes), "
                  f"{preps[-1]['bound_ms'] / ms:.2f} of it; host {host_ms:.4f} ms per call",
                  flush=True)
    results["fused_actor_critic_prep"] = dict(
        max_abs_err=0.0, **{k: preps[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by", "host_ms")},
        bound_peak="HBM3, 3.35 TB/s", checked_against="plain version, bit for bit",
        by_shape=preps)

    # The wide route at the wide paths' shapes: H = 1024, B = 1024 with value
    # (the H=1024 train's agent forward and bootstrap) and without (its pool
    # slot), B = 256 without (the h1024 eval's forward), B = 16 without (the
    # trains' eval), B = 100 and 50 without (the all-agents ladder's games a
    # seat order for the nets and for the search pairs), B = 8192 with value;
    # H = 1280, B = 512 with value (its train's rollout) and B = 8192 with
    # value.  Beside the route on a plain
    # list (prep + kernel, in the mode B derives), in the same call:
    # each mode alone (weights prepared once) and the other mode with its
    # prep, the plain forward and the addmm chain.
    wides = []
    for H, B, with_value in ((1024, 1024, True), (1024, 1024, False), (1024, 256, False),
                             (1024, 16, False), (1024, 100, False), (1024, 50, False),
                             (1024, 8192, True), (1280, 512, True), (1280, 8192, True)):
        w_h = random_weights(H)
        obs, mask = obs_all[:B].contiguous(), mask_all[:B].contiguous()
        x32 = obs.to(torch.float32)

        def addmm_wide(x32=x32, w_h=w_h, heads=(0, 6) if with_value else (0,)):
            for o in heads:
                h = torch.tanh(torch.addmm(w_h[o + 1], x32, w_h[o]))
                h = torch.tanh(torch.addmm(w_h[o + 3], h, w_h[o + 2]))
                torch.addmm(w_h[o + 5], h, w_h[o + 4])

        prepared = fac.prepare_weights(w_h, with_value)
        mode = fac.wide_mode(B, H, with_value)
        route_ms, host_ms = device_ms(lambda: fac.fused_masked_forward(w_h, obs, mask, with_value),
                                      20, per_call=4)
        mode_ms = {m: device_ms(lambda: fac._launch("wide", w_h, obs, mask, with_value, prepared,
                                                    mode=m), 20, per_call=3)[0]
                   for m in wide_modes_}
        prep_ms = {m: route_ms if m == mode else device_ms(
            lambda: fac._launch("wide", w_h, obs, mask, with_value, mode=m), 20, per_call=4)[0]
            for m in wide_modes_}
        plain_ms = device_ms(lambda: fac.fused_masked_forward_plain(w_h, obs, mask,
                                                                    with_value), 20)[0]
        library_ms = device_ms(addmm_wide, 20)[0]
        bound_ms, bound_by, bound_f32_ms = bound_a(B, H, with_value, l1_products)
        wides.append(dict(B=B, H=H, with_value=with_value, mode=mode, ms=mode_ms[mode],
                          route_ms=route_ms, mode_ms=mode_ms, mode_prep_ms=prep_ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, bound_f32_ms=bound_f32_ms,
                          host_ms=host_ms))
        print(f"kernel A wide route B={B} H={H} value={with_value}: "
              + ", ".join(f"{m} {t:.4f}" for m, t in mode_ms.items()) + " ms alone; with its "
              "prep " + ", ".join(f"{m} {t:.4f}" for m, t in prep_ms.items()) + f" ms (the path: "
              f"{mode}); plain {plain_ms:.4f} ms, addmm chain {library_ms:.4f} ms (device clock); "
              f"bound {bound_ms:.4f} ms by {bound_by} (3xTF32, layer 1 in {l1_products} "
              f"products), {bound_f32_ms:.4f} ms on f32 CUDA cores; host {host_ms:.4f} ms per "
              f"call", flush=True)
    # Each wide mode's row at a shape that the path runs in it: B = 8192 at
    # H = 1024 with value in pass mode, the pool slot (B = 1024, no value)
    # in half mode, unless their B derive the other mode.
    for m, B0, v0 in (("pass", 8192, True), ("half", 1024, False)):
        row = next((r for r in wides if r["mode"] == m and r["B"] == B0 and r["H"] == 1024
                    and r["with_value"] == v0), None) or next(r for r in wides if r["mode"] == m)
        results["fused_actor_critic_wide_" + m] = dict(
            mode=m, max_abs_err=err_wide,
            shape=dict(B=row["B"], H=row["H"], with_value=row["with_value"]),
            ms=row["mode_ms"][m], route_ms=row["mode_prep_ms"][m],
            **{k: row[k] for k in ("plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "bound_f32_ms", "host_ms")},
            bound_peak="TF32 tensor cores (3xTF32), 494.7 TFLOP/s",
            checked_against="plain version in float64, rtol/atol 1e-5; the other mode bit for bit",
            by_shape=wides if m == "pass" else "as fused_actor_critic_wide_pass")

    # Kernel B: ring row take, at W = 8192 (the league rollout's window) and
    # at B = W = 1024 (the train phase's).
    rng = np.random.RandomState(0)
    R = 16384
    packed = torch.as_tensor(rng.randint(-1, 90, size=(R + 8192, 135)).astype(np.int8),
                             device=device)
    # The last number is the rank offset: under dp=2 a rank's ranks start
    # after the done games of the ranks before it (B=4096 of W=8192).
    for B, W, p_done, ptr0, off in ((8192, 8192, 0.03, 5, 0), (8192, 8192, 0.5, 12000, 0),
                                    (8192, 8192, 1.0, R - 1, 0), (8191, 8192, 0.5, 77, 0),
                                    (12000, 8192, 1.0, 3, 0), (1024, 1024, 0.03, 5, 0),
                                    (1024, 1024, 1.0, 2047, 0), (1500, 1024, 1.0, 3, 0),
                                    (4096, 8192, 0.03, 5, 0), (4096, 8192, 0.03, 9000, 131),
                                    (4096, 8192, 1.0, 77, 4096)):
        done = torch.as_tensor(rng.rand(B) < p_done, device=device)
        rank = torch.cumsum(done, 0) - done.long() + off
        ptr = torch.tensor(ptr0, dtype=torch.int64, device=device)
        got = rt.take_rows(packed, ptr, rank, W)
        want = rt.take_rows_plain(packed, ptr, rank, W)
        torch.cuda.synchronize()
        e = (got.int() - want.int()).abs().max().item()
        check(e == 0, f"kernel B disagrees at B={B} W={W} p={p_done}: max abs err {e}")
        if B > W and p_done == 1.0:
            check(rank.max().item() > W - 1, "the overflow case did not overflow")
    print("kernel B: exact against plain at W=8192 (B=8192 and a dp=2 rank's 4096 with its "
          "offset) and W=1024, overflow cases included", flush=True)
    B = W = 8192
    done = torch.as_tensor(rng.rand(B) < 0.03, device=device)
    rank = torch.cumsum(done, 0) - done.long()
    ptr = torch.tensor(5, dtype=torch.int64, device=device)
    idx = ptr + torch.clamp(rank, max=W - 1)
    ms, host_ms = device_ms(lambda: rt.take_rows(packed, ptr, rank, W), 200)
    plain_ms = device_ms(lambda: rt.take_rows_plain(packed, ptr, rank, W), 200)[0]
    library_ms, library_host_ms = device_ms(lambda: torch.index_select(packed, 0, idx), 200)
    nbytes = 2 * B * 135 + 8 * B + 8
    # A dp=2 rank's take: 4096 rows of the W=8192 window, after an offset.
    rank_r = torch.cumsum(done[:4096], 0) - done[:4096].long() + 131
    idx_r = ptr + torch.clamp(rank_r, max=W - 1)
    ms_r = device_ms(lambda: rt.take_rows(packed, ptr, rank_r, W), 200)[0]
    plain_r = device_ms(lambda: rt.take_rows_plain(packed, ptr, rank_r, W), 200)[0]
    library_r = device_ms(lambda: torch.index_select(packed, 0, idx_r), 200)[0]
    bound_r = (2 * 4096 * 135 + 8 * 4096 + 8) / H100_BYTES_PER_S * 1e3
    print(f"kernel B B=4096 W={W} (a dp=2 rank): {ms_r:.5f} ms, plain {plain_r:.5f} ms, "
          f"index_select {library_r:.5f} ms; bound {bound_r:.5f} ms by bytes", flush=True)
    results["ring_take"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", host_ms=host_ms,
        bound_peak="HBM3, 3.35 TB/s",
        by_shape=[dict(B=B, W=W, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=nbytes / H100_BYTES_PER_S * 1e3),
                  dict(B=4096, W=W, offset=131, ms=ms_r, plain_ms=plain_r, library_ms=library_r,
                       bound_ms=bound_r)],
    )
    print(f"kernel B B={B} W={W}: {ms:.5f} ms (device clock), plain {plain_ms:.5f} ms, "
          f"index_select {library_ms:.5f} ms; bound {results['ring_take']['bound_ms']:.5f} ms "
          f"by bytes; host {host_ms:.4f} ms per call (index_select {library_host_ms:.4f})",
          flush=True)
    kernel_token_return(device)
    results.update(kernel_engine_ply(device))
    return results


def kernel_engine_ply(device) -> dict:
    """The fast-mode ply's kernels (`ops/engine_ply`) bit for bit against the
    plain functions on the card, at the static league cell's calls
    (`_site_inputs`): the step kernel as the agent's ply (mask given, obs,
    live mask; 8,192 games), a playout step (frozen lanes, obs and mask;
    32,768) and the search's children (apply only, 1,024 x 8); the observe
    kernel as the reset (select; 8,192), the lanes (gathered rows, obs and
    mask; 8,192 of 8,192) and the turn's observation (mask & ~done; 8,192).
    Each timed on the device clock and the host's beside the plain
    functions, eagerly.  Bound: each call's bytes read and written once,
    HBM3."""
    import torch

    from splendax_torch.engine import rules
    from splendax_torch.engine.encode import encode_observation
    from splendax_torch.env import core
    from splendax_torch.ops import engine_ply as ep
    from splendax_torch.search.mc import repeat_rows

    t0 = time.perf_counter()
    site = _site_inputs(device, 23)
    st, a, mask = site["dual.agent"]
    lanes, la, lmask = site["mc.playout"]
    root, cand = site["gumbel.children"]
    done, fresh, cur = site["dual.reset"]
    child, lane_child = site["gumbel.lanes"]
    state_b, deck_b, obs_b = 74 * 4, 120 * 4, 297 * 4  # a game's record, deck_perm, obs

    def leaves(x):
        out = []
        for v in (x if isinstance(x, tuple) else (x,)):
            out += [t for _, t in v.items()] if hasattr(v, "items") else [v]
        return out

    def playout_plain():
        nxt = core.select(rules.is_terminal(lanes), lanes,
                          core.step_core_plain(lanes, la, mask=lmask)[0])
        return nxt, encode_observation(nxt), rules.legal_mask(nxt)

    def reset_plain():
        carry = core.select(done, fresh, cur)
        return carry, encode_observation(carry), rules.legal_mask(carry)

    def lanes_plain():
        flat = child.map(lambda x: x[lane_child])
        return flat, encode_observation(flat), rules.legal_mask(flat)

    cases = {
        "engine_ply_step": [
            ("agent ply B=8192", 8192,
             lambda: ep.step(st, a, mask, with_obs=True, with_mask=True, mask_live=True),
             lambda: core.step_plain(st, a, mask=mask),
             lambda got: (got[0], got[1]["reward"], got[2], got[3]),
             lambda want: (want[0], want[1].reward, want[1].obs, want[1].action_mask),
             state_b + 4 + 8 + 45 + state_b + 16 + obs_b + 45),
            ("playout step B=32768", 32768,
             lambda: ep.step(lanes, la, lmask, freeze_terminal=True, with_obs=True,
                             with_mask=True),
             playout_plain, lambda got: (got[0], got[2], got[3]), lambda want: want,
             state_b + 4 + 8 + 45 + state_b + 16 + obs_b + 45),
            ("children 1024 x 8", 8192,
             lambda: ep.step(root, cand.reshape(-1), apply_only=True, repeat=8),
             lambda: rules.apply_action_plain(repeat_rows(root, 8), cand.reshape(-1)),
             lambda got: got[0], lambda want: want,
             (state_b + deck_b) / 8 + 8 + state_b + deck_b),
        ],
        "engine_ply_observe": [
            # A lane reads the one row it selects (fresh or the state), and done.
            ("reset select B=8192", 8192, lambda: ep.observe(cur, fresh=fresh, done=done),
             reset_plain, lambda got: got, lambda want: want,
             (state_b + deck_b) + 1 + state_b + deck_b + obs_b + 45),
            ("lanes gather B=8192", 8192, lambda: ep.observe(child, rows=lane_child),
             lanes_plain, lambda got: got, lambda want: want,
             state_b + deck_b + 8 + state_b + deck_b + obs_b + 45),
            ("observation B=8192", 8192, lambda: ep.observe(cur, done=done, mask_off=True),
             lambda: (encode_observation(cur), rules.legal_mask(cur) & ~done[:, None]),
             lambda got: got[1:], lambda want: want, state_b + 1 + obs_b + 45),
        ],
    }
    results = {}
    for name, rows in cases.items():
        shapes = []
        for label, n, run, plain, pick, pick_plain, per_lane in rows:
            got, want = leaves(pick(run())), leaves(pick_plain(plain()))
            check(len(got) == len(want) and all(
                x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want)),
                f"{name} {label}: the kernel differs from the plain functions")
            ms, host_ms = device_ms(run, 100)
            plain_ms, plain_host_ms = device_ms(plain, 5)
            bound_ms = n * per_lane / H100_BYTES_PER_S * 1e3
            shapes.append(dict(call=label, lanes=n, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                               plain_host_ms=plain_host_ms, bound_ms=bound_ms))
            print(f"{name} {label}: exact; {ms:.5f} ms (device clock), host {host_ms:.4f} ms a "
                  f"call; plain {plain_ms:.5f} ms, host {plain_host_ms:.4f} ms; bound "
                  f"{bound_ms:.5f} ms by bytes ({per_lane:.0f} a lane)", flush=True)
        first = shapes[0]
        results[name] = dict(max_abs_err=0.0, ms=first["ms"], plain_ms=first["plain_ms"],
                             library_ms=None, bound_ms=first["bound_ms"], bound_by="bytes",
                             host_ms=first["host_ms"], bound_peak="HBM3, 3.35 TB/s",
                             by_shape=shapes)
    print(f"the ply's kernels: checked and timed in {time.perf_counter() - t0:.1f} s", flush=True)
    return results


def kernel_token_return(device) -> None:
    """The step kernel's token return (`csrc/token_return.cuh`) exact
    against `return_tokens_plain` on fuzzed hands (every k from 0 to 12,
    gold-only hands, hands past 22) at B = 8192 (the league's plies) and
    36,000 (flat MC's lanes at 100 games), and on the post-move hands of
    8192 games in play.  Each hand's game reserves a visible card with no
    gold in the bank, a move that leaves the tokens as they are, so the
    kernel's return is of the hand itself."""
    t0 = time.perf_counter()
    import numpy as np
    import torch

    from splendax_torch.engine import data as D
    from splendax_torch.engine import rules
    from splendax_torch.engine.state import initial_state
    from splendax_torch.env import core
    from splendax_torch.ops import engine_ply as ep
    from splendax_torch.ops import token_return as tr
    from splendax_torch.selfplay.opponents import uniform_legal_action

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _token_hands import fuzzed_hands

    def post_move(B, plies, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        st, _, mask = core.reset(B, g, device)
        for _ in range(plies):
            st, out = core.step(st, uniform_legal_action(mask, g), mask=mask)
            mask = out.action_mask
        moved = rules._grant_noble(rules._apply_move(st, uniform_legal_action(mask, g).long()))
        return {"tokens": moved.tokens, "bank": moved.bank.clone(), "to_play": moved.to_play,
                "turn_count": moved.turn_count}

    for label, B, h in (
            ("fuzzed", 8192, None), ("fuzzed", 36000, None), ("in play", 8192, post_move(8192, 24, 5))):
        if h is None:
            h = {k: torch.from_numpy(v).to(device)
                 for k, v in fuzzed_hands(np.random.RandomState(B), B).items()}
        h["bank"][:, D.GOLD] = 0
        st = initial_state(B, torch.Generator(device=device).manual_seed(B), device).replace(**h)
        a = torch.full((B,), rules.RESERVE_VISIBLE_OFFSET, dtype=torch.int64, device=device)
        before = ep.launches["step"]
        got, want = rules.apply_action(st, a), tr.return_tokens_plain(**h)
        check(ep.launches["step"] == before + 1, "token return: not one step launch a call")
        check(torch.equal(got.tokens, want[0]) and torch.equal(got.bank, want[1]),
              f"token return: the step kernel differs from the plain version ({label}, B={B})")
        k = (h["tokens"][torch.arange(B, device=device), h["to_play"].long()].sum(1) - 10).clamp(min=0)
        if label == "fuzzed":
            check(set(range(13)) <= set(k.tolist()), f"token return: fuzzed k {sorted(set(k.tolist()))}")
        print(f"token return {label} B={B} ({int((k > 0).sum())} over the cap): the step kernel's "
              "exact", flush=True)
    print(f"token return: checked in {time.perf_counter() - t0:.1f} s", flush=True)


def _site_inputs(device, seed: int) -> dict:
    """{site: args} of one call of each engine site at the static league
    cell's shapes: the dual turn's plies and reset at 8,192 games, the
    Gumbel search's children (1,024 games x m 8) and lanes (8,192 from
    them), a playout step at 32,768 lanes; games 0 to 199 random plies deep,
    ~3% of the actions illegal."""
    import torch

    from splendax_torch.engine import rules
    from splendax_torch.engine.state import initial_state
    from splendax_torch.env import core
    from splendax_torch.selfplay import dual
    from splendax_torch.selfplay.opponents import uniform_legal_action

    g = torch.Generator(device=device).manual_seed(seed)
    st = initial_state(32768, g, device)
    stop = torch.randint(0, 200, (32768,), generator=g, device=device)
    for ply in range(200):
        mask = rules.legal_mask(st)
        nxt, _ = core.step(st, uniform_legal_action(mask, g), mask=mask)
        st = core.select(stop > ply, nxt, st)

    def games(n):
        rows = torch.randint(0, 32768, (n,), generator=g, device=device)
        return st.map(lambda x: x[rows])

    def actions(mask):
        a = uniform_legal_action(mask, g)
        wild = torch.rand(a.shape, generator=g, device=device) < 0.03
        return torch.where(wild, torch.randint(0, 45, a.shape, generator=g, device=device), a)

    s = games(8192)
    mask = rules.legal_mask(s)
    a = actions(mask)
    s1, out = dual._agent_ply(s, a, mask)
    lanes = games(32768)
    lane_mask = rules.legal_mask(lanes)
    return {
        "dual.agent": (s, a, mask),
        "dual.opponent": (s1, actions(out.action_mask), out.action_mask, out.terminated,
                          out.reward, out.final_rewards, out.turn_limit),
        "dual.reset": (torch.rand(8192, generator=g, device=device) < 0.1, games(8192), s),
        "gumbel.children": (games(1024), torch.randint(0, 45, (1024, 8), generator=g,
                                                       device=device)),
        "gumbel.lanes": (games(8192), torch.randint(0, 8192, (8192,), generator=g,
                                                    device=device)),
        "mc.playout": (lanes, actions(lane_mask), lane_mask),
    }


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
                           ("terminal obs", out_c.obs, out_g.obs),
                           ("terminal mask", out_c.action_mask, out_g.action_mask),
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


# Phase 3's invocations of `python -m splendax_torch.bench`: the env workload
# at bench.py's shape (its defaults), the league update with and without
# its search slot (the committed weights), and time_search's four bots cut
# to 16 games and one timed rep.
SEARCH_BENCH_GAMES = 16
BENCH_RUNS = {
    "bench env": ("--workload", "env"),
    "bench update none": ("--workload", "update", "--slot", "none"),
    "bench update static": ("--workload", "update", "--slot", "static"),
    **{f"bench search {bot}": ("--workload", "search", "--bot", bot, "--games",
                               str(SEARCH_BENCH_GAMES), "--reps", "1")
       for bot in ("mc", "gumbel", "uct", "greedy")},
}
BENCH_COMMON_KEYS = ("metric", "value", "unit", "mean", "median", "per_rep", "backend", "device",
                     "host", "detail")


def phase_bench() -> dict:
    """Phase 3: the benchmark's invocations (BENCH_RUNS), each a process of
    its own; each line is checked against the bench's contract and printed.
    Returns each invocation's launch counts, as `read_launches` keys them."""
    paths = {}
    for path, args in BENCH_RUNS.items():
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "splendax_torch.bench", *args], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        check(out.returncode == 0, f"{path}: exit {out.returncode}\n{out.stderr[-4000:]}")
        lines = out.stdout.splitlines()
        check(len(lines) == 1, f"{path}: {len(lines)} lines on stdout: {out.stdout[-2000:]}")
        line = json.loads(lines[0])
        print(f"{path} ({time.perf_counter() - t0:.1f} s with start-up): {lines[0]}", flush=True)
        check(all(k in line for k in BENCH_COMMON_KEYS), f"{path}: a key is missing")
        check(line["backend"] == "cuda" and line["device"]["count"] >= 1
              and line["value"] == round(max(line["per_rep"]), 1) > 0,
              f"{path}: backend, device or value off the contract")
        if path == "bench env":
            check(line["metric"] == "env_steps_per_sec_per_chip" and line["unit"] == "steps/s"
                  and "vs_baseline" in line and line["batch"] == 32768 and line["steps"] == 400
                  and len(line["per_rep"]) == 5, f"{path}: not bench.py's shape or keys")
            check(line["ring_overflow"] == 0, f"{path}: ring overflow {line['ring_overflow']}")
            check(line["ring_take_launches"] == 6 * 400,
                  f"{path}: kernel B launched {line['ring_take_launches']} times, not 6 x 400")
            paths[path] = dict(dict.fromkeys(read_launches(), 0),
                               ring_take=line["ring_take_launches"])
        elif path.startswith("bench search"):
            check(line["metric"] == "search_moves_per_sec" and line["unit"] == "agent moves/s"
                  and line["bot"] == path.split()[-1] and line["games"] == SEARCH_BENCH_GAMES
                  and line["seed"] == 7 and line["hidden"] == 768 and len(line["per_rep"]) == 1
                  and line["evals_counted"] == 2, f"{path}: not time_search's bot, net or seed")
            check(line["illegal_action_rate"] == 0 and line["agent_moves"] > 0
                  and 0 < line["turns_played"] <= 100 and line["ms_per_move"] > 0,
                  f"{path}: illegal moves or no moves: {line['illegal_action_rate']}, "
                  f"{line['agent_moves']} moves in {line['turns_played']} turns")
            n = line["launches_per_eval"]
            check_route(path, n)
            check(n["ring_take"] == 0 and n["fused_actor_critic_prep"] == 1,
                  f"{path}: kernel B launched or the bots' handle prepared more than once: {n}")
            # Each eval launched the warm-up's forwards; only the warm-up prepared.
            paths[path] = {k: v if k in ("fused_actor_critic_prep", "derived_prep")
                           else v * line["evals_counted"] for k, v in n.items()}
        else:
            steps = line["optimizer_steps_per_rep"]
            check(line["metric"] == "agent_steps_per_sec" and line["num_envs"] == 8192
                  and line["num_steps"] == 64 and line["hidden"] == 768 and len(steps) == 3
                  and line["seed"] == 42 and line["update"]["update"] == 3812,
                  f"{path}: not the league recipe's shape, seed or update")
            check(steps == [line["optimizer_steps_max"]] * 3 == [64] * 3,
                  f"{path}: the reps took {steps} optimizer steps, not the run's 64")
            n = line["launches_per_update"]
            check_route(path, n)
            check(n["ring_take"] == 64, f"{path}: kernel B launched {n['ring_take']} times")
            # The update writes CURRENT before its first forward: that slot
            # prepares once, and so may any slot the saved state left stale.
            check(line["preparations_per_update"] == n["fused_actor_critic_prep"]
                  and 1 <= n["fused_actor_critic_prep"] <= 1 + line["slots_stale_at_start"],
                  f"{path}: {n['fused_actor_critic_prep']} preparations an update with "
                  f"{line['slots_stale_at_start']} slots stale at its start")
            # Every counted update launched the same kernels (the bench checks it).
            paths[path] = {k: v * line["updates_counted"] for k, v in n.items()}
    return paths


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
    check(launches["fused_actor_critic"] > 0 and launches["ring_take"] > 0,
          f"a kernel was not launched: {launches}")
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


def phase_update(device) -> dict:
    """The league recipe's learner at full width: one warm-up `update_step`,
    two timed ones, and the learner's arithmetic held against the CPU."""
    import torch

    from splendax_torch.eval import suite
    from splendax_torch.models import actor_critic as ac
    from splendax_torch.train import ppo

    cfg = league_config("none")
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
    with timed_calls(ppo, LEARNER_PHASES, seconds, last):
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
    with timed_calls(ppo, LEARNER_PHASES, {}, last):
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


FLAGSHIP = "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"
# runs/distill_h768/results.json's recipe: its source net, teacher and fit.
DISTILL_RECIPE = ["--rollouts", "16", "--horizon", "4", "--max-plies", "120", "--sample-plies", "20",
                  "--c-scale", "20", "--target", "gumbel", "--lr", "2e-4", "--minibatch", "4096",
                  "--seed", "37"]


def check_dataset(data: dict, where: str) -> None:
    """The distill dataset contract on numpy rows [N, ...]: keys and dtypes,
    q -inf exactly on illegal actions and finite on legal ones, its argmax
    the recorded action, the raw logits finite, the weighted rows' outcomes
    in the terminal alphabet."""
    import numpy as np

    dtypes = {"obs": np.int32, "mask": np.bool_, "q": np.float32, "logits": np.float32,
              "action": np.int32, "z": np.float32, "weight": np.float32}
    check({k: v.dtype for k, v in data.items()} == {k: np.dtype(t) for k, t in dtypes.items()},
          f"{where}: keys or dtypes {[(k, v.dtype) for k, v in data.items()]}")
    q, mask = data["q"], data["mask"]
    live = mask.any(-1)
    check(np.isneginf(q[~mask]).all() and np.isfinite(q[mask]).all(), f"{where}: q's -inf pattern")
    check((q[live].argmax(-1) == data["action"][live]).all(), f"{where}: action is not q's argmax")
    check(np.isfinite(data["logits"]).all() and (data["logits"] > -1e8).all(),
          f"{where}: the root logits are not the raw head")
    w = data["weight"] > 0
    check(np.isin(np.round(data["z"][w], 2), [-1.0, -0.1, 0.0, 1.0]).all(),
          f"{where}: an outcome outside the terminal alphabet")


def phase_distill(device) -> dict:
    """Search distillation on the card: (a) the CLI through its entry point
    on the committed recipe, depth cut; (b) one generation chunk at the
    recipe's width, 1024 games x 45 x 16 = 737,280 playout lanes; (c) the
    loop on the card against the CPU on the same draws.  Returns each
    path's launches."""
    import numpy as np
    import torch

    from splendax_torch.engine import state as S
    from splendax_torch.env import core
    from splendax_torch.eval import suite
    from splendax_torch.models.actor_critic import import_params_npz
    from splendax_torch.train import distill

    paths = {}
    # (a) The CLI, the recipe's teacher and fit; 256 games in one chunk of
    # 256 x 45 x 16 = 184,320 lanes, 2 epochs, a gate of 64 games a seat.
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["--npz", os.path.join(ROOT, FLAGSHIP), "--out", out_dir] + DISTILL_RECIPE + [
            "--games", "256", "--gen-batch", "256", "--epochs", "2", "--gate-games", "64",
            "--iters", "1", "--save-data", os.path.join(out_dir, "data.npz")]
        seconds, by_call = {}, {}
        zero_launches()
        t0 = time.perf_counter()
        with timed_calls(distill, ("generate_search_games", "distill_fit"), seconds, {}, by_call), \
                timed_calls(suite, ("head_to_head",), seconds, {}, by_call):
            distill.main(argv, device=device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        paths["distill"] = read_launches()
        with open(os.path.join(out_dir, "results.json")) as f:
            res = json.load(f)
        (it,) = res["iterations"]
        check(set(res) == {"iterations", "source_npz", "accepted", "config"}
              and set(it) == {"iter", "generation", "fit_history", "gate", "promoted"}
              and len(it["fit_history"]) == 2 and it["gate"]["n"] == 128
              and res["accepted"] == int(it["promoted"]), f"distill CLI: results.json {res}")
        gen = it["generation"]
        with np.load(os.path.join(out_dir, "data.npz")) as f:
            data = {k: f[k] for k in f.files if k != "_stats"}
        check_dataset(data, "distill CLI dataset")
        check(len(data["obs"]) == gen["n_samples"] > 0 and (data["weight"] == 1).all(),
              f"distill CLI: {len(data['obs'])} rows for {gen}")
        check(all(np.isfinite(list(h.values())).all() for h in it["fit_history"]),
              f"distill CLI: fit history {it['fit_history']}")
        out = import_params_npz(os.path.join(out_dir, "distilled_params.npz"), device=device)
        src = import_params_npz(os.path.join(ROOT, FLAGSHIP), device=device)
        same = all(torch.equal(a, b) for a, b in zip(out.parameters(), src.parameters()))
        check(same != it["promoted"], "distill CLI: the npz does not follow the gate")
        check(by_call["generate_search_games"] == 6 * 120 and by_call["distill_fit"] == 0,
              f"distill CLI: kernel A launches by call {by_call}, not 6 a ply in generation")
    print(f"distill CLI (recipe r16 h4, 256 games in one chunk of 184,320 lanes, 120 plies, "
          f"2 epochs, gate 64 games a seat): {dt:.3f} s; generate "
          f"{seconds['generate_search_games']:.3f} s ({seconds['generate_search_games'] / 120:.4f} s "
          f"a ply), fit {seconds['distill_fit']:.3f} s, gate {seconds['head_to_head']:.3f} s; "
          f"dataset {gen}; fit {it['fit_history']}; gate score {it['gate']['score']:.3f}"
          f"±{it['gate']['score_ci95']:.3f}, promoted {it['promoted']}; kernel A by call "
          f"{by_call}; launches {paths['distill']}", flush=True)

    # (b) One chunk at the recipe's width: 1024 games, 6 sampled plies.
    net = import_params_npz(os.path.join(ROOT, FLAGSHIP), device=device)
    gen = torch.Generator(device=device).manual_seed(37)

    def chunk(plies):
        return distill._generate(net, gen, 1024, 16, 4, plies, "fast", True, 20, 20.0, False)

    chunk(1)  # warm-up, not kept
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    data, stats = chunk(6)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    paths["distill chunk"] = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(paths["distill chunk"]["fused_actor_critic"] == 6 * 6
          and paths["distill chunk"]["ring_take"] == 0,
          f"distill chunk: launches {paths['distill chunk']}, not 6 a ply")
    check(tuple(data["obs"].shape) == (6, 1024, 297), f"distill chunk: obs {data['obs'].shape}")
    check_dataset({k: v.reshape((-1,) + tuple(v.shape[2:])).cpu().numpy() for k, v in data.items()},
                  "distill chunk")
    print(f"distill chunk (1024 games x 45 x 16 rollouts = 737,280 lanes, horizon 4, H=768): "
          f"{dt / 6:.4f} s a generation ply (6 plies in {dt:.3f} s); peak memory {peak} bytes; "
          f"kernel A {paths['distill chunk']['fused_actor_critic'] / 6:.0f} launches a ply",
          flush=True)

    # (c) The card against the CPU on the same deals, draws and played
    # moves.  The playouts are unguided: a guided move is the argmax of
    # logits + noise, which a 1e-6 difference of the kernel's logits could
    # flip; the leaves and the root prior still run kernel A on the card.
    cg = torch.Generator().manual_seed(5)
    B, K, hz, plies = 8, 2, 2, 30
    state0 = core.reset(B, cg, "cpu")[0]
    draws = [[torch.rand(B * 45 * K, generator=cg) for _ in range(hz)] for _ in range(plies)]
    net_c = import_params_npz(os.path.join(ROOT, FLAGSHIP), device="cpu")
    want, want_stats = distill._generate(net_c, None, B, K, hz, plies, guided=False,
                                         state0=state0, draws=draws)
    zero_launches()
    got, got_stats = distill._generate(
        net, None, B, K, hz, plies, guided=False, state0=S.from_numpy(S.to_numpy(state0), device),
        draws=[[d.to(device) for d in ply] for ply in draws],
        play=[a.to(device) for a in want["action"]])
    torch.cuda.synchronize()
    paths["distill card vs CPU"] = read_launches()
    got = {k: v.cpu() for k, v in got.items()}
    for k in ("obs", "mask", "z", "weight"):
        check(torch.equal(got[k], want[k]), f"distill card vs CPU: {k} differs")
    legal = want["mask"]
    check(torch.equal(torch.isneginf(got["q"]), torch.isneginf(want["q"])),
          "distill card vs CPU: q's -inf pattern differs")
    q_err = (got["q"][legal] - want["q"][legal]).abs().max().item()
    check(torch.allclose(got["q"][legal], want["q"][legal], rtol=1e-5, atol=1e-5),
          f"distill card vs CPU: q differs by {q_err}")
    l_err = (got["logits"] - want["logits"]).abs().max().item()
    check(torch.allclose(got["logits"], want["logits"], rtol=F32_PLAIN_SLACK * 1e-5,
                         atol=F32_PLAIN_SLACK * 1e-5), f"distill card vs CPU: logits off by {l_err}")
    check(want_stats["n_samples"].item() == got_stats["n_samples"].item(),
          "distill card vs CPU: stats differ")
    check(paths["distill card vs CPU"]["fused_actor_critic"] == 2 * plies,
          f"distill card vs CPU: launches {paths['distill card vs CPU']}, not a leaf batch and "
          "a root prior a ply")
    print(f"distill card vs CPU ({B} games, r{K} h{hz}, {plies} plies, unguided playouts, the "
          f"flagship net): obs, mask, z and weight equal; q within {q_err:.3g}, root logits within "
          f"{l_err:.3g}; launches on the card {paths['distill card vs CPU']}", flush=True)
    return paths


def probed_update(cfg, ts):
    """One `update_step` -> (ts, seconds, record): the record holds the
    rollout, the first minibatch's loss and the gradients its optimizer
    step took, and the optimizer steps the KL stop left."""
    import torch

    from splendax_torch.train import optim, ppo

    rec = {}
    rollout, step, loss = ppo.rollout, optim.step, ppo.ppo_loss

    def rollout_kept(*args):
        out = rollout(*args)
        rec["traj"] = out[1]
        return out

    def loss_kept(*args, **kw):
        out = loss(*args, **kw)
        rec.setdefault("loss", out[0].detach().clone())
        return out

    def step_kept(params, grads, *args, **kw):
        rec.setdefault("grads", [g.detach().clone() for g in grads])
        return step(params, grads, *args, **kw)

    ppo.rollout, optim.step, ppo.ppo_loss = rollout_kept, step_kept, loss_kept
    try:
        count0 = ts.opt_state.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = ppo.update_step(cfg, ts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        ppo.rollout, optim.step, ppo.ppo_loss = rollout, step, loss
    rec["steps"] = ts.opt_state.count - count0
    return ts, dt, rec


def parallel_rank(runs) -> dict:
    """On each rank of a gloo group sharing the card: for each (label, dp,
    tp, turns) of `runs`, the league recipe's update on that mesh from the
    flagship state, after a 2-turn warm-up; returns this rank's rows of the
    rollout, the first minibatch's loss (this rank's part) and whole
    gradients, the steps, the whole params, the time, the kernel launches,
    and under tp the time of the whole-weight gather."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from splendax_torch.models import actor_critic as ac
    from splendax_torch.parallel import collectives
    from splendax_torch.parallel.multihost import local_device

    dev = local_device("cuda")
    check(dev.type == "cuda", f"a rank runs on {dev}")
    with derived_modes():
        out = {}
        for label, dp, tp, turns in runs:
            cfg = league_config("none").replace(num_steps=turns, dp=dp, tp=tp)
            probed_update(cfg.replace(num_steps=2), flagship_state(cfg, dev))  # warm-up
            ts = flagship_state(cfg, dev)
            zero_launches()
            dist.barrier()
            ts, dt, rec = probed_update(cfg, ts)
            launches = read_launches()
            mesh, traj = ts.mesh, rec["traj"]
            check(traj.obs.is_cuda and ts.params.actor[0].weight.is_cuda, "a rank left the card")
            dims = ts.params.shard_dims or [None] * len(rec["grads"])
            grads = [g if d is None else collectives.all_gather_cat(g, mesh.tp_group, d)
                     for g, d in zip(rec["grads"], dims)]
            gather_ms = None
            if tp > 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    ac.gather_full_weights(ts.params)
                torch.cuda.synchronize()
                gather_ms = (time.perf_counter() - t0) * 1e3 / 5
            out[label] = dict(
                action=traj.action.to(torch.int8).cpu().numpy(), reward=traj.reward.cpu().numpy(),
                done=traj.done.cpu().numpy(), overflow=int(traj.overflow), loss=rec["loss"].item(),
                grads=[g.cpu().numpy() for g in grads], steps=rec["steps"],
                params=[p.detach().cpu().numpy() for p in ac.whole_model(ts.params).parameters()],
                seconds=dt, launches=launches, dp_rank=mesh.dp_rank, tp_rank=mesh.tp_rank,
                gather_ms=gather_ms, device=str(dev), routes=dict(collectives.routes))
        return out


def phase_parallel(device) -> dict:
    """dp and tp over gloo ranks sharing the card, against one process."""
    import numpy as np
    import torch

    from splendax_torch.models import actor_critic as ac
    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.parallel import bench_scaling, dryrun
    from splendax_torch.parallel.multihost import spawn
    from splendax_torch.train import ppo

    # Kernel A's rows must not depend on B for a rank's half of the batch
    # to equal the same rows of the whole batch.
    w = ac.kernel_weights(ac.import_params_npz(os.path.join(ROOT, FLAGSHIP), device=device))
    obs, mask = realistic_obs(8192, 30, seed=768, device=device)
    whole = fac.fused_masked_forward(w, obs, mask)
    for cut in (4096, 1000):
        parts = [fac.fused_masked_forward(w, obs[a:b].contiguous(), mask[a:b].contiguous())
                 for a, b in ((0, cut), (cut, 8192))]
        same_b = all(torch.equal(torch.cat([h[j] for h in parts]), whole[j]) for j in (0, 1))
        print(f"parallel: kernel A on {cut} + {8192 - cut} rows equals the B=8192 call bit for "
              f"bit: {same_b}", flush=True)
        check(same_b, f"kernel A's rows depend on B: {cut} + {8192 - cut} against 8192")

    runs = (("dp", 2, 1, 64), ("tp", 1, 2, 8))
    t0 = time.perf_counter()
    ranks = spawn(parallel_rank, 2, args=(runs,), device="cuda", timeout=600)
    print(f"parallel: 2 gloo ranks on {ranks[0]['dp']['device']}, {time.perf_counter() - t0:.1f} s "
          f"with start-up; collective routes of rank 0 {ranks[0]['tp']['routes']}", flush=True)
    launches = dict.fromkeys(read_launches(), 0)
    for label, dp, tp, turns in runs:
        cfg = league_config("none").replace(num_steps=turns)
        ts1, dt, rec = probed_update(cfg, flagship_state(cfg, device))
        traj, n = rec["traj"], cfg.num_envs // dp
        for r in ranks:
            got = r[label]
            rows = slice(got["dp_rank"] * n, (got["dp_rank"] + 1) * n)
            for k in ("action", "reward", "done"):
                want = getattr(traj, k)[:, rows].cpu().numpy()
                check(np.array_equal(got[k], want.astype(got[k].dtype)),
                      f"parallel {label}: a rank's rollout {k} differs from one process's rows")
            check(got["overflow"] == int(traj.overflow), f"parallel {label}: overflow differs")
            check(got["steps"] == rec["steps"], f"parallel {label}: {got['steps']} optimizer steps "
                  f"before the KL stop, one process {rec['steps']}")
            for k, v in got["launches"].items():
                launches[k] += v
        # Under dp each rank's loss is its part of the minibatch's sum.
        loss = sum(r[label]["loss"] for r in ranks if r[label]["tp_rank"] == 0)
        worst = 0.0
        for name, got, want in ([("loss", np.float64(loss), rec["loss"])]
                                + [(f"grad[{i}]", g, rec["grads"][i])
                                   for i, g in enumerate(ranks[0][label]["grads"])]):
            want = want.detach().double().cpu().numpy()
            atol = 1e-5 * np.abs(want).max()
            err = (np.abs(np.asarray(got, np.float64) - want) / (atol + 1e-4 * np.abs(want))).max()
            check(err <= 1.0, f"parallel {label}: {name} is {err:.3f} of rtol 1e-4 off one process")
            worst = max(worst, err)
        single = [p.detach().cpu().numpy() for p in ts1.params.parameters()]
        moved = max(np.abs(a - b).max() for a, b in zip(ranks[0][label]["params"], single))
        lr = ppo._anneal(cfg, 0)[0]
        gather = ranks[0][label]["gather_ms"]
        print(f"parallel {label}={max(dp, tp)} (N={cfg.num_envs}, T={turns}, H={cfg.hidden}): "
              f"rollout rows bit-equal to one process's; first minibatch loss and 12 gradients "
              f"within {worst:.3f} of rtol 1e-4; {rec['steps']} optimizer steps in both; params "
              f"max |diff| {moved:.3g} = {moved / lr:.3f} lr; update "
              f"{ranks[0][label]['seconds']:.4f} s on the ranks, {dt:.4f} s in one process"
              + (f"; whole-weight gather {gather:.3f} ms" if gather is not None else ""),
              flush=True)

    t0 = time.perf_counter()
    results = dryrun.dryrun_multichip(4, device="cuda")
    check(all(r["device"].startswith("cuda") for r in results), "a dry-run rank left the card")
    for r in results:
        for k, v in r["launches"].items():
            launches[k] += v
        # The dry run's forwards take at most 64 rows (8 games, a search of
        # m k0 = 8 lanes each), so each derives the cluster mode.
        check(fac.wgmma_mode(64, 256) == "cluster", "the dry run's B no longer derive cluster mode")
        launches["derived_cluster"] += r["launches"]["fused_actor_critic_wgmma"]
        # Its weight preparations, 3 a rank: CURRENT's handle once in each of
        # its two updates (`set_current` writes it before the first forward,
        # and with no snapshot in the pool every game faces CURRENT), and the
        # search's handle once.
        launches["derived_prep"] += 3
    print(f"parallel: dryrun_multichip(4) on the card, {time.perf_counter() - t0:.1f} s; routes of "
          f"rank 0 {results[0]['routes']}", flush=True)
    bench_scaling.main(["--ranks", "2", "--batch-per-rank", "4096", "--steps", "20", "--reps", "1",
                        "--device", "cuda"])
    return launches


def phase_wide(device) -> dict:
    """`train.train` past the wgmma route's 768, on kernel A's wide route:
    at hidden 1024 one update of 1024 games x 8 turns from random weights,
    with the eval suite at step 0; at hidden 1280 (wider than the 1024 the
    port once refused) one update of 512 x 8.  The agent forwards and the
    bootstraps take pass mode, the evals' 16 rows half mode.  The counters are zeroed before each
    run and read after it; returns their sums."""
    import torch

    from splendax_torch.train import train

    total = {}
    for H, envs in ((1024, 1024), (1280, 512)):
        with tempfile.TemporaryDirectory() as log_dir:
            cfg = train.parse_args([
                "--num-envs", str(envs), "--num-steps", "8", "--hidden", str(H),
                "--total-timesteps", str(envs * 8), "--eval-games", "16",
                "--eval-every-updates", "99", "--checkpoint-every-updates", "99",
                "--snapshot-every-updates", "99", "--log-dir", log_dir])
            zero_launches()
            t0 = time.perf_counter()
            ts = train.train(cfg, device=device)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = read_launches()
        check(ts.update_idx == 1, f"train H={H}: ended at update {ts.update_idx}")
        check(launches["fused_actor_critic"] >= 2 * cfg.num_steps + 1
              and launches["ring_take"] > 0, f"train H={H}: launches {launches}")
        check_route(f"train H={H}", launches, route="wide")
        print(f"train H={H}: 1 update of {cfg.num_envs} x {cfg.num_steps} with an eval of "
              f"4 x {cfg.eval_games} games in {dt:.3f} s; launches {launches}", flush=True)
        total = {k: total.get(k, 0) + n for k, n in launches.items()}
    check(all(total["fused_actor_critic_wide_" + m] > 0 for m in ("pass", "half")),
          f"the wide trains did not launch both wide modes: {total}")
    return total


def phase_eval_h1024(device) -> dict:
    """The committed h1024 net (`runs/ppo_splendor_2b_h1024`, full width)
    greedy against the basic heuristic over 256 games on the card, every
    forward through kernel A's wide route; its win rate beside the one the
    JAX run recorded over 400 games (`final_eval.json`).  Each forward's
    rows and outputs are kept, and after the counters are read every one is
    held within rtol/atol 1e-5 of the float64 plain forward and within
    F32_PLAIN_SLACK of the float32 one on the committed weights, and the
    wide route's other mode gives it bit for bit."""
    import torch

    from splendax_torch.eval import suite
    from splendax_torch.models import actor_critic as ac
    from splendax_torch.ops import fused_actor_critic as fac

    run = os.path.join(ROOT, "runs", "ppo_splendor_2b_h1024")
    params = ac.import_params_npz(os.path.join(run, "ppo_splendor_params.npz"), device=device)
    check(params.hidden == 1024, f"h1024 net has hidden {params.hidden}")
    with open(os.path.join(run, "final_eval.json")) as f:
        recorded = json.load(f)["basic"]
    seen = []
    launch = fac._launch

    def kept(r, weights, obs, mask, with_value, *args, **kwargs):
        out = launch(r, weights, obs, mask, with_value, *args, **kwargs)
        seen.append((obs.clone(), None if mask is None else mask.clone(), with_value, out))
        return out

    zero_launches()
    fac._launch = kept
    try:
        t0 = time.perf_counter()
        r = suite.run_evaluation_suite(params, 256, seed=0, opponents=["basic"],
                                       device=device)["basic"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        fac._launch = launch
    launches = read_launches()
    check_route("eval h1024", launches, route="wide")
    check(len(seen) == launches["fused_actor_critic"], f"eval h1024: kept {len(seen)} forwards")
    w = ac.kernel_weights(params)
    w64 = [t.double() for t in w]
    worst, worst32, sizes = 0.0, 0.0, set()
    for obs, mask, with_value, got in seen:
        where = f"eval h1024, B={obs.shape[0]} value={with_value}"
        sizes.add(obs.shape[0])
        refs = (plain_forward(w64, obs, mask, with_value), plain_forward(w, obs, mask, with_value))
        for g, ref, f32 in zip(got, *refs):
            if g is None:
                continue
            e64 = ((g.double() - ref).abs() / (1e-5 + 1e-5 * ref.abs())).max().item()
            e32 = ((g.double() - f32.double()).abs() / (1e-5 + 1e-5 * f32.double().abs())).max().item()
            check(torch.isfinite(g).all().item() and e64 <= 1.0 and e32 <= F32_PLAIN_SLACK,
                  f"{where}: the wide route is {e64:.3f} of the tolerance from float64, "
                  f"{e32:.3f} from float32")
            worst, worst32 = max(worst, e64), max(worst32, e32)
        for m in fac.launches_by_wide_mode:
            forced = fac._launch("wide", w, obs, mask, with_value, mode=m)
            check(all(a is None or torch.equal(a, b) for a, b in zip(got, forced)),
                  f"{where}: the wide route's {m} mode differs from the path's forward")
    print(f"eval h1024: its {len(seen)} forwards (B in {sorted(sizes)}) on the committed "
          f"weights: {worst:.3f} of the rtol/atol 1e-5 tolerance vs the float64 plain forward, "
          f"{worst32:.3f} vs float32 (at most {F32_PLAIN_SLACK}); both wide modes bit-equal",
          flush=True)
    check(r["n"] == 256 and r["illegal_action_rate"] == 0, f"eval h1024: {r}")
    # The recorded rate is 0.9675 +- 0.0174 over 400 games; 0.9 is far below
    # any 256-game sample of it, and far above what a broken forward plays.
    check(r["win_rate"] >= 0.9, f"eval h1024: win rate {r['win_rate']} vs basic, recorded "
          f"{recorded['win_rate']}")
    print(f"eval h1024 (committed net, H=1024, greedy vs basic, 256 games): wr={r['win_rate']:.4f} "
          f"(recorded {recorded['win_rate']:.4f} over {recorded['n']}), turns {r['avg_turns']:.2f}, "
          f"{dt:.3f} s; launches {launches}", flush=True)
    return launches


def plain_forward(weights, obs, mask, with_value):
    """The plain forward of a kernel A launch's arguments: (logits, value),
    or (None, value) for the critic alone (no mask)."""
    from splendax_torch.ops import fused_actor_critic as fac

    if mask is None:
        return None, fac.fused_value_forward_plain(weights, obs)
    return fac.fused_masked_forward_plain(weights, obs, mask, with_value)


def keep_forwards(seen: list):
    """A context in which every kernel A launch whose mode the wrapper picks
    appends (route, weights, obs, mask, with_value, outputs) to `seen`."""
    from splendax_torch.ops import fused_actor_critic as fac

    launch = fac._launch

    def kept(r, weights, obs, mask, with_value, *args, **kwargs):
        out = launch(r, weights, obs, mask, with_value, *args, **kwargs)
        seen.append((r, weights, obs.clone(), None if mask is None else mask.clone(), with_value,
                     out))
        return out

    @contextlib.contextmanager
    def patched():
        fac._launch = kept
        try:
            yield
        finally:
            fac._launch = launch

    return patched()


def hold_forwards(seen: list, path: str) -> set:
    """Each forward kept by `keep_forwards`, on the weights it was given:
    within rtol/atol 1e-5 of the float64 plain forward, its route's other
    mode bit for bit, on the route its width gives; and at every output
    within F32_PLAIN_SLACK of the float32 plain forward, or nearer the
    float64 forward than the float32 one is.  Both forwards round in
    float32, each up to about the tolerance off float64 on the search lanes,
    so they can lie more than the slack apart where the kernel is the nearer
    to exact.  Prints the worst shares and how many outputs lay beyond the
    slack; returns the widths seen."""
    import torch

    from splendax_torch.ops import fused_actor_critic as fac

    def share(a, b):
        """|a - b| as a share of the rtol/atol 1e-5 tolerance about b."""
        a, b = a.double(), b.double()
        return (a - b).abs() / (1e-5 + 1e-5 * b.abs())

    widths, sizes = set(), set()
    worst, worst32, f32_worst, beyond = 0.0, 0.0, 0.0, 0
    for r, weights, obs, mask, with_value, got in seen:
        H = weights[0].shape[1]
        where = f"{path}, H={H} B={obs.shape[0]} value={with_value}"
        check(r == fac.route(H), f"{where}: took the {r} route")
        widths.add(H)
        sizes.add(obs.shape[0])
        w = list(weights)
        refs = (plain_forward([t.double() for t in w], obs, mask, with_value),
                plain_forward(w, obs, mask, with_value))
        for g, ref, f32 in zip(got, *refs):
            if g is None:
                continue
            d64, d32, f64 = share(g, ref), share(g, f32), share(f32, ref)
            apart = d32 > F32_PLAIN_SLACK
            e64, e32 = d64.max().item(), d32.max().item()
            check(torch.isfinite(g).all().item() and e64 <= 1.0
                  and not (apart & (d64 >= f64)).any().item(),
                  f"{where}: kernel A is {e64:.3f} of the tolerance from float64, {e32:.3f} from "
                  f"float32 (float32 {f64.max().item():.3f} from float64)")
            worst, worst32 = max(worst, e64), max(worst32, e32)
            f32_worst = max(f32_worst, f64.max().item())
            beyond += int(apart.sum())
        modes = fac.launches_by_mode if r == "wgmma" else fac.launches_by_wide_mode
        for m in tuple(modes):
            forced = fac._launch(r, w, obs, mask, with_value, mode=m)
            check(all(a is None or torch.equal(a, b) for a, b in zip(got, forced)),
                  f"{where}: the {r} route's {m} mode differs from the path's forward")
    print(f"{path}: its {len(seen)} forwards (H in {sorted(widths)}, B in {sorted(sizes)}) on "
          f"the committed weights: {worst:.3f} of the rtol/atol 1e-5 tolerance vs the float64 "
          f"plain forward, {worst32:.3f} vs float32 ({beyond} outputs beyond {F32_PLAIN_SLACK}, "
          f"the kernel nearer float64 at each); the float32 plain forward itself up to "
          f"{f32_worst:.3f} off float64; each route's modes bit-equal", flush=True)
    return widths


def check_modes(path: str, launches: dict, n_seen: int) -> None:
    """Every kernel A launch of the path was kept, took the wgmma or the wide
    route in the mode its B derives, and prepared as its weights called for."""
    from splendax_torch.ops import fused_actor_critic as fac

    others = [r for r in fac.launches_by_route if r not in ("wgmma", "wide")]
    check(n_seen == launches["fused_actor_critic"] > 0
          and all(launches["fused_actor_critic_" + r] == 0 for r in others)
          and launches["fused_actor_critic_prep"] == launches["derived_prep"],
          f"{path}: kept {n_seen} forwards; launches {launches}")
    for r, names in (("wgmma", ("tile", "cluster")), ("wide", ("wide_pass", "wide_half"))):
        check(all(launches["fused_actor_critic_" + m] == launches["derived_" + m] for m in names),
              f"{path}: kernel A's {r} modes are not those its B derive: {launches}")


# The ladder phase's cut of the committed ladder: every committed width,
# both routes of kernel A, and one search bot.
LADDER_CUT = ("basic:ppo_2b_h256", "ppo_2b_h256:ppo_2b_h512", "noble:ppo_2b_h768",
              "ppo_2b_h768:ppo_2b_h1024", "basic:mc_h768")


def phase_ladder(device) -> dict:
    """`python -m splendax_torch.eval.ladder` through `main`, with the
    search rows, on a cut of the committed ladder (`runs/elo_ladder.json`):
    a temporary --out holds every other scheduled pair as already played (the
    committed results), so the ladder plays the LADDER_CUT pairs alone, the
    nets' at 32 games a seat order and the search bot's at 8.  Every forward
    is kept; after the counters are read each is held by `hold_forwards`
    on the committed weights (the float64 and float32 plain forwards, its
    route's other mode bit for bit) and took the route its net's width gives
    (the h1024 net the wide route, the others wgmma).  Each played pair's z against the
    committed pair (`scripts/torch_ladder_compare.py`) must be within 4."""
    import importlib.util

    import torch

    from splendax_torch.eval import ladder, suite

    with open(ladder.COMMITTED) as f:
        committed = json.load(f)
    entries = ladder.roster_entries(include_search=True)
    labels = [label for label, _, _ in entries]
    is_search = {label: kind == "search" for label, kind, _ in entries}
    keys = [f"{labels[i]}:{labels[j]}"
            for i, j in ladder.schedule(labels, is_search, {"ppo_2b_h768", "basic"})]
    check(set(LADDER_CUT) <= set(keys) <= set(committed["pairs"]),
          f"ladder: the schedule's {len(keys)} pairs are not the committed ladder's")
    prior = {k: committed["pairs"][k] for k in keys if k not in LADDER_CUT}
    seen, secs = [], []
    h2h = suite.head_to_head

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        res = h2h(*args, **kwargs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return res

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ladder.json")
        with open(out, "w") as f:
            json.dump({"pairs": prior, "privileged": committed["privileged"]}, f)
        zero_launches()
        suite.head_to_head = timed
        try:
            with keep_forwards(seen):
                t0 = time.perf_counter()
                payload = ladder.main(["--games", "32", "--search-games", "8", "--include-search",
                                       "--out", out], device=device)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
        finally:
            suite.head_to_head = h2h
        launches = read_launches()
    played = [k for k in keys if k in LADDER_CUT]
    check(len(secs) == len(LADDER_CUT) and set(payload["pairs"]) == set(keys)
          and payload["partial"] is False and set(payload["elo"]) == set(labels),
          f"ladder: played {len(secs)} pairs, wrote {len(payload['pairs'])}")
    for key, s in zip(played, secs):
        res = payload["pairs"][key]
        n = 8 if "mc_h768" in key else 32
        check(res["n"] == 2 * n and all(res[seat]["illegal_action_rate"] == 0
                                        for seat in ("first_seat", "second_seat")),
              f"ladder {key}: {res}")
        print(f"ladder {key}: {n} games a seat order in {s:.3f} s, score "
              f"{res['score']:.4f}±{res['score_ci95']:.4f}, turns "
              f"{res['first_seat']['avg_turns']:.2f}/{res['second_seat']['avg_turns']:.2f}",
              flush=True)
    # Routes per net: its width's, in the mode each B derives.
    check_modes("ladder", launches, len(seen))
    check(launches["fused_actor_critic_wgmma"] > 0 and launches["fused_actor_critic_wide"] > 0,
          f"ladder: both routes of kernel A should launch: {launches}")
    widths = hold_forwards(seen, "ladder")
    check(widths == {256, 512, 768, 1024}, f"ladder: forwards at widths {sorted(widths)}")
    spec = importlib.util.spec_from_file_location(
        "torch_ladder_compare", os.path.join(ROOT, "scripts", "torch_ladder_compare.py"))
    compare = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(compare)
    for key, s_p, s_r, se, z in compare.pair_z({k: payload["pairs"][k] for k in played},
                                               committed["pairs"]):
        print(f"ladder {key}: z = {z:.3f} (port {s_p:.4f}, committed {s_r:.4f}, se {se:.4f})",
              flush=True)
        check(abs(z) <= 4.0, f"ladder {key}: |z| = {abs(z):.3f} against the committed pair")
    print(f"ladder: {len(played)} pairs in {dt:.3f} s ({sum(secs):.3f} s of games); launches "
          f"{launches}", flush=True)
    return launches


# The duel replay phase's cut of `python -m splendax_torch.eval.duel_replay`:
# PUCT on the card, the censored Gumbel search at k12, and a model eval of
# the H=256 league nets.
DUEL_REPLAY_CUT = ("uct_vs_gumbel_h768", "cgumbelfk12_vs_cmc_h768_r5",
                   "censored_vs_priv_league_s43")
DUEL_REPLAY_GAMES = 16


def phase_duel_replay(device) -> dict:
    """`python -m splendax_torch.eval.duel_replay` through `main` on the
    DUEL_REPLAY_CUT entries at 16 games a seat order, into a temporary
    --out-dir.  Each file holds the committed key at n = 32, and each z
    against the committed file (`scripts/torch_ladder_compare.py --duel`,
    from the cut's own CI) is within 4.  Every forward is held as the
    ladder phase holds its forwards."""
    import torch

    from splendax_torch.eval import duel_replay

    seen = []
    argv = [a for name in DUEL_REPLAY_CUT for a in ("--only", name)]
    with tempfile.TemporaryDirectory() as tmp:
        zero_launches()
        with keep_forwards(seen):
            t0 = time.perf_counter()
            out = duel_replay.main([*argv, "--games", str(DUEL_REPLAY_GAMES), "--out-dir", tmp],
                                   device=device)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = read_launches()
        written = {}
        for name in DUEL_REPLAY_CUT:
            with open(os.path.join(tmp, name + ".json")) as f:
                written[name] = json.load(f)
    check(list(out["entries"]) == list(DUEL_REPLAY_CUT), f"duel replay: {list(out['entries'])}")
    for name, row in out["entries"].items():
        with open(os.path.join(duel_replay.COMMITTED_DIR, name + ".json")) as f:
            committed = json.load(f)
        (key, res), = written[name].items()
        check(key in committed and res["n"] == 2 * DUEL_REPLAY_GAMES and row["seconds"]
              and all(res[seat]["illegal_action_rate"] == 0
                      for seat in ("first_seat", "second_seat")),
              f"duel replay {name}: {key} at n {res['n']}")
        check(len(row["rows"]) == 1, f"duel replay {name}: rows {row['rows']}")
        _, s_p, s_r, se, z, proto = row["rows"][0]
        print(f"duel replay {name} ({row['limit']}): {DUEL_REPLAY_GAMES} games a seat order in "
              f"{row['seconds']:.3f} s, score {s_p:.4f} against the committed {s_r:.4f} "
              f"({proto}), se {se:.4f}, z {z:.3f}", flush=True)
        check(abs(z) <= 4.0, f"duel replay {name}: |z| = {abs(z):.3f} against the committed file")
    check_modes("duel replay", launches, len(seen))
    check(launches["fused_actor_critic_wide"] == 0, f"duel replay: a wide launch {launches}")
    widths = hold_forwards(seen, "duel replay")
    check(widths == {256, 768}, f"duel replay: forwards at widths {sorted(widths)}")
    print(f"duel replay: {len(DUEL_REPLAY_CUT)} entries in {dt:.3f} s; launches {launches}",
          flush=True)
    return launches


def phase_ppo_generic(device) -> float:
    """`ppo_generic` on the port's env, on the card, 2 updates of 4 envs x
    128 steps (the reference defaults), through gymnasium or its stand-ins."""
    import io

    import numpy as np
    import torch

    from splendax_torch.env import _gym
    from splendax_torch.train import ppo_generic

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        agent, returns = ppo_generic.main(["--env-id", "SplendaxTorch-v0", "--total-timesteps",
                                           "1024"], device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    check(len(lines) == 2 and lines[-1].startswith("update=2/2 SPS="), f"ppo_generic: {lines}")
    check(next(agent.parameters()).device.type == "cuda"
          and all(torch.isfinite(p).all().item() for p in agent.parameters()),
          "ppo_generic: the agent is not finite on the card")
    print(f"ppo_generic on SplendaxTorch-v0 ({'gymnasium' if _gym.HAVE_GYMNASIUM else 'stand-ins'}"
          f", 4 envs x 128 steps, 2 updates, H=64 on the card): {1024 / dt:.1f} env steps/s "
          f"({dt:.3f} s incl. set-up); its last line: {lines[-1]}; {len(returns)} episodes ended "
          f"(mean return {np.mean(returns) if returns else float('nan'):.3f})", flush=True)
    return 1024 / dt


def profile_distill_ply(device) -> None:
    """Where a generation ply's time goes at 737,280 lanes: one ply on the
    host clock, then one under torch.profiler."""
    import torch

    from splendax_torch.models.actor_critic import import_params_npz
    from splendax_torch.train import distill

    net = import_params_npz(os.path.join(ROOT, FLAGSHIP), device=device)
    gen = torch.Generator(device=device).manual_seed(38)

    def ply():
        distill._generate(net, gen, 1024, 16, 4, 1, "fast", True, 20, 20.0, False)
        torch.cuda.synchronize()

    ply()
    t0 = time.perf_counter()
    ply()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = profiled_kernels(ply)
    check(kernels, "distill profile: the profiler saw no device time")
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile (distill ply, 737,280 lanes): {wall_ms:.3f} ms on the host clock; device busy "
          f"{dev_ms:.3f} ms in {sum(e.count for e in kernels)} kernel launches "
          f"({100 * dev_ms / wall_ms:.1f}% busy)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:90]}", flush=True)


def phase_league(device):
    """The league recipe with its search slot at full width: a warm-up
    update, a timed one, and one more with the search timed on its own."""
    import torch

    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.train import ppo

    cfg = league_config("static")
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
    with timed_calls(ppo, LEARNER_PHASES, seconds, last):
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
    # The critic alone: the search's leaves, one a halving round, and the bootstrap.
    check(launches["fused_actor_critic_critic_only"] == T * rounds + 1,
          f"league: {launches['fused_actor_critic_critic_only']} forwards of the critic alone, "
          f"not {T} x {rounds} + 1")
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


def phase_handles(device) -> None:
    """Two league updates (the recipe with its static search slot, full
    width, the full pool) on the pool's prepared-weight handles: the first
    pushes a snapshot at its end; the second runs from the bench's deep copy
    of the state it left; then a checkpoint restore.  Every forward on a
    handle (the agent, the pool slots, the league search, the bootstrap)
    equals, bit for bit, the same forward on a freshly prepared plain list
    of the same weights, in the same mode.  The comparison launches are this
    phase's own: no path counts them."""
    import torch

    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.train import checkpoint, ppo

    cfg = league_config("static")
    ts = flagship_state(cfg, device, full_pool=True)
    k = cfg.snapshot_every_updates
    ts.update_idx = (cfg.num_updates - 2) // k * k - 1  # an update whose end pushes a snapshot
    checked = {}
    launch = fac._launch

    def compare(r, weights, obs, mask, with_value, prepared=None, lib=None, mode=None):
        out = launch(r, weights, obs, mask, with_value, prepared, lib, mode)
        if isinstance(weights, fac.PreparedWeights) and prepared is None and obs.shape[0] > 0:
            fresh = launch(r, list(weights), obs, mask, with_value, None, lib, mode)
            where = next((i for i, h in enumerate(pool_now[0].slots) if h is weights), "search")
            check(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(out, fresh)),
                  f"handles: a forward on slot {where}'s handle (B={obs.shape[0]}, value="
                  f"{with_value}) differs from the same forward on freshly prepared weights")
            checked[where] = checked.get(where, 0) + 1
        return out

    pool_now = [ts.pool]
    preps, stale = [], 0
    fac._launch = compare
    try:
        for i in range(2):
            before = sum(h.preparations for h in ts.pool.slots)
            pool_now[0] = ts.pool
            n_snap = ts.pool.n_snapshots
            ts, _ = ppo.update_step(cfg, ts)
            torch.cuda.synchronize()
            preps.append(sum(h.preparations for h in ts.pool.slots) - before)
            if i == 0:
                pushed = n_snap % ts.pool.pool_size
                was = [h.stale() for h in ts.pool.slots]
                check(ts.pool.n_snapshots == n_snap + 1 and was[pushed] and not was[-1],
                      f"handles: after the snapshot push into slot {pushed}, stale slots {was}")
                ts = restore_state(save_state(ts))  # the bench's deep copy
                check([h.stale() for h in ts.pool.slots] == was,
                      "handles: the deep copy did not keep the current preparations")
                stale = sum(was)
    finally:
        fac._launch = launch
    # CURRENT after its write, and at most each slot the first update left
    # stale (the pushed one among them).
    check(1 <= preps[1] <= 1 + stale,
          f"handles: {preps[1]} preparations in the second update, {stale} slots stale")
    # A checkpoint restore: new handles over the restored stack, each equal
    # to the plain preparation of its slot.
    fresh = checkpoint.load_state_dict(ppo.init_train_state(cfg, device=device),
                                       checkpoint.state_dict(ts))
    for j, h in enumerate(fresh.pool.slots):
        check(h.stale() and torch.equal(h.buffer(), fac.prepare_weights_plain(list(h)))
              and all(torch.equal(a, b) for a, b in zip(h, ts.pool.slot(j))),
              f"handles: slot {j} after the checkpoint restore")
    print(f"handles: two league updates (static slot, full pool, the first pushing slot "
          f"{pushed}, the second from its deep copy): every handle forward equals the forward "
          f"on freshly prepared weights bit for bit ({sum(checked.values())} forwards: "
          f"{dict(sorted(checked.items(), key=str))} by slot); preparations on handles "
          f"{preps[0]} and {preps[1]}; after a checkpoint restore every slot's handle prepares "
          f"the restored weights bit for bit", flush=True)


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
    cfg = league_config("none").replace(reset_ring_mult=0)
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
    kernels = profiled_kernels(lambda: turns(n))
    check(kernels, "profile: the profiler saw no device time")
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    count = sum(e.count for e in kernels) / n
    print(f"{label}: {wall_ms:.3f} ms/turn on the host clock; device busy {dev_ms:.3f} ms/turn "
          f"in {count:.0f} kernel launches ({100 * dev_ms / wall_ms:.1f}% busy)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/turn  {e.count / n:6.1f}x  "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    with derived_modes():
        return run_phases()


def run_phases() -> int:
    """Every phase, in order, with kernel A's modes derived from its shapes
    (`derived_modes`)."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    device = torch.device("cuda", 0)

    secs, reports = _build.timed_build()
    print(f"build: {secs:.2f} s for {sorted(reports)}", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    phase_engine_agreement(device)
    bench_paths = phase_bench()
    launches, cfg, ts = phase_rollout(device)
    by_path = {"rollout": launches, "update": phase_update(device), "train": phase_train(device)}
    by_path.update((p, n) for p, n in bench_paths.items() if p != "bench env")
    zero_launches()
    phase_search(device)
    by_path["search"] = read_launches()
    by_path["league"], cfg_league, ts_league = phase_league(device)
    phase_handles(device)
    phase_parity(device)
    zero_launches()
    phase_cli(device)
    by_path["cli"] = read_launches()
    by_path["host"] = phase_host(device)
    by_path.update(phase_distill(device))
    phase_ppo_generic(device)
    by_path["parallel"] = phase_parallel(device)
    check(by_path["parallel"]["fused_actor_critic"] > 0 and by_path["parallel"]["ring_take"] > 0,
          f"the parallel path did not launch both kernels: {by_path['parallel']}")
    # Every path above runs a net of H <= 768: all its kernel A launches take
    # the wgmma route.  The wide paths (H = 1024 and 1280) take the wide
    # route, which phase_wide and phase_eval_h1024 check.
    for path, n in by_path.items():
        check_route(path, n)
    # The call sites of the cluster mode: the pool slots (rollout, update,
    # league), the eval suite (update, train), the root prior (league,
    # distill) and the host policies (host).
    for path in ("rollout", "update", "train", "league", "host", "distill", "distill chunk"):
        check(by_path[path]["fused_actor_critic_cluster"] > 0,
              f"{path}: no kernel A launch took the cluster mode: {by_path[path]}")
    print("kernel A's wgmma launches by mode (tile / cluster, as their B derive): " + "; ".join(
        f"{path} {n['fused_actor_critic_tile']} / {n['fused_actor_critic_cluster']}"
        for path, n in by_path.items()), flush=True)
    by_path["bench env"] = bench_paths["bench env"]  # kernel B alone
    by_path["train H=1024, 1280"] = phase_wide(device)
    by_path["eval h1024"] = phase_eval_h1024(device)
    by_path["ladder"] = phase_ladder(device)  # both routes: checked per net inside
    by_path["duel replay"] = phase_duel_replay(device)
    kern = phase_kernels(device)
    phase_profile(cfg, ts)
    phase_profile(cfg_league, ts_league, label="profile (league slot)")
    profile_distill_ply(device)

    tpu_a = "splendax/ops/fused_actor_critic.py:37"
    meta = {
        "fused_actor_critic_tile": ("splendax_torch/csrc/fused_actor_critic_wgmma.cu", tpu_a),
        "fused_actor_critic_cluster": ("splendax_torch/csrc/fused_actor_critic_wgmma.cu", tpu_a),
        "fused_actor_critic_prep": ("splendax_torch/csrc/fused_actor_critic_wgmma.cu", tpu_a),
        "fused_actor_critic_critic_only": ("splendax_torch/csrc/fused_actor_critic_wgmma.cu",
                                           tpu_a),
        "fused_actor_critic_wide_pass": ("splendax_torch/csrc/fused_actor_critic_wgmma.cu", tpu_a),
        "fused_actor_critic_wide_half": ("splendax_torch/csrc/fused_actor_critic_wgmma.cu", tpu_a),
        "ring_take": ("splendax_torch/csrc/ring_take.cu", "splendax/ops/ring_take.py:38"),
        "engine_ply_step": ("splendax_torch/csrc/engine_ply.cu",
                            "none: a port kernel (splendax/env/core.py step, XLA-fused)"),
        "engine_ply_observe": ("splendax_torch/csrc/engine_ply.cu",
                               "none: a port kernel (splendax/engine/encode.py and "
                               "rules.legal_mask, XLA-fused)"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        k = kern[name]
        # launches: the sum over the driven paths, each counted from 0.
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=sum(p[name] for p in by_path.values()),
                         launches_by_path={path: p[name] for path, p in by_path.items()}, **k))
        check(rows[-1]["launches"] > 0, f"{name} was launched on no driven path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where kernel A's time goes on one GPU: variants of its source (both routes),
their times beside the `addmm` chain, and the tensor cores' mma.sync TF32 rate.

    python3 scripts/torch_kernel_a_probe.py            # everything below, ~2 min
    python3 scripts/torch_kernel_a_probe.py --check    # build, check, small-B timings; ~1 min
    python3 scripts/torch_kernel_a_probe.py --check --parent DIR   # and DIR's wgmma kernel
    python3 scripts/torch_kernel_a_probe.py --wide     # the wide route (H > 768) alone; ~1 min

Builds variants of `splendax_torch/csrc/fused_actor_critic_wgmma.cu` (both
routes) with nvcc (sm_90a, the flags of `splendax_torch/ops/_build.py`)
under `build/probe/`, each with the probe switches its source documents, and
times each on the device clock as chip_smoke.py's kernel phase does, with the
committed h768 net on engine obs.  Prints the card's name and power limit
first, and each new variant's ptxas report (registers, spills, and any
wgmma serialisation warning).

--check: the `wgmma` route in each mode against the float64 plain forward
(rtol/atol 1e-5) on seeded random weights at H = 37, 100, 256, 768 and B =
1, 63, 64, 65, 4097, and on the committed h256 and h768 nets at B = 8192,
the two modes bit for bit against each other; the prep kernel against
`prepare_weights_plain` bit for bit; rows independent of B (1,000 + 7,192
and 4,096 + 4,096 against 8,192); then a cluster-mode block's steps on
%globaltimer (the clocks variants: median us of each step over the blocks
and the spread of their starts, at B = 64 and 2048 without value and 8192
with it; at B = 64 also without weight loads, without obs loads and without
head-weight loads); then timings of both modes at B = 1, 256, 512, 1024,
2048, 3072 without value, 4096 and 8192 with it, with the no_loads variants
beside them at 8192.  Every variant is called through the wrapper
(`fused_actor_critic._launch` with the variant's library and a forced mode),
as the path calls the library's own build.

--wide: only the wide route (H > 768, the same source): both its modes
checked against the float64 plain forward and against each other bit for
bit at H = 1024, 1280 and 2048 (B = 1, 65, 8192, with and without value);
both modes alone beside the addmm chain at H = 1024 and 1280, B = 16, 256,
512, 1024, 2048 and 4096, with and without value (where half mode stops
paying: `WIDE_HALF_MAX_BLOCKS`); then at H = 1024, B = 1024 with and without
value and B = 8192 with value, and H = 1280, B = 8192 with value, the
route's split in the mode B derives: the kernel alone, each of its three
launches (layer 1, layer 2 with the partial heads, the outputs:
device-clock sums by kernel), its one_product, no_loads and no_loads_one
variants and the addmm chain.

--parent DIR: also builds DIR/splendax_torch/csrc/fused_actor_critic_wgmma.cu
(another tree's wgmma kernel, with this tree's C interface for its tile
and cluster modes: a `groups` argument, 0 for tile mode) and times it on the same prepared weights, in turns with
this tree's tile mode (parent, tile, tile, parent, parent, tile), at B =
8192, 32768 and 737280 with value and at B = 2048 without.

Without --check, after the checks:

  wgmma route, B = 8192, 32768, 737280, with and without value: the kernel
  (weights prepared once), the prep kernel alone, the route as the wrapper
  runs it (prep + kernel), the addmm chain;
  variants at B = 8192 and 32768 with value:
  one_product      one TF32 product per f32 one (wrong numbers: the same
                   loads with a third of the tensor work);
  no_loads         no weight stage is ever copied (wrong numbers: the
                   compute alone);
  no_loads_one     both;
  B = 1, 256, 512, 1024, 2048, 3072 without value and 4096 with it (the
  host policies, the eval, a full pool's snapshot slot, the root prior, the
  pool slots, a dp=2 rank): both modes and the addmm chain; the tensor
  cores' mma.sync TF32 rate per SM clock (the heads' products).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe")
WGMMA_VARIANTS = {
    "wgmma": (),
    "wgmma_one_product": ("-DPROBE_ONE_PRODUCT",),
    "wgmma_no_loads": ("-DPROBE_NO_LOADS",),
    "wgmma_no_loads_one": ("-DPROBE_NO_LOADS", "-DPROBE_ONE_PRODUCT"),
    "wgmma_clocks": ("-DPROBE_CLOCKS",),
    "wgmma_clocks_no_loads": ("-DPROBE_CLOCKS", "-DPROBE_NO_LOADS"),
    "wgmma_clocks_no_obs": ("-DPROBE_CLOCKS", "-DPROBE_NO_OBS"),
    "wgmma_clocks_no_w2": ("-DPROBE_CLOCKS", "-DPROBE_NO_W2"),
}
CLOCKS = ("wgmma_clocks", "wgmma_clocks_no_loads", "wgmma_clocks_no_obs", "wgmma_clocks_no_w2")
# The compute alone: timed in --check too.
WGMMA_SPLIT = ("wgmma_no_loads", "wgmma_no_loads_one")
# A cluster block's steps, between the clocks variant's stamps 0-9, 6-10, 10-11, 11-7.
STEPS = ("obs and mask scan", "cluster sync", "role split", "layer 1", "copies out",
         "layer 2 as the columns come in",
         "head, partials written", "reduction", "reads done", "head", "all in", "partials written",
         "bias and tanh", "head product")

MMA_LOOP = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void loop(int iters, float* out) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(j), "r"(i));
  float t = 0.f;
  for (int j = 0; j < 8; ++j) t += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
extern "C" int run(int blocks, int iters, float* out) {
  loop<<<blocks, 256>>>(iters, out);
  return (int)cudaGetLastError();
}
"""


def build(check: bool, parent: str | None = None, wide: bool = False) -> dict:
    """{name: loaded library} for every variant (with --check only the
    wgmma kernel and its no_loads variants; with --wide those and
    one_product), each bound by the wrapper, and the mma loop;
    prints the wgmma variants' ptxas reports."""
    from splendax_torch.ops import _build
    from splendax_torch.ops import fused_actor_critic as fac

    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, flags in WGMMA_VARIANTS.items():
        if wide and name not in ("wgmma", "wgmma_one_product") + WGMMA_SPLIT:
            continue
        if not check or wide or name in ("wgmma",) + CLOCKS + WGMMA_SPLIT:
            jobs[name] = (_build.CSRC / "fused_actor_critic_wgmma.cu",
                          os.path.join(OUT, f"lib{name}.so"), flags)
    if parent is not None:
        jobs["parent"] = (os.path.join(parent, "splendax_torch", "csrc",
                                       "fused_actor_critic_wgmma.cu"),
                          os.path.join(OUT, "libparent.so"), ())
    if not check and not wide:
        loop_cu = os.path.join(OUT, "mma_loop.cu")
        with open(loop_cu, "w") as f:
            f.write(MMA_LOOP)
        jobs["mma_loop"] = (loop_cu, os.path.join(OUT, "libmma_loop.so"), ())
    reports = _build.compile_many(jobs)
    for name, rep in reports.items():
        if name.startswith("wgmma"):
            lines = [ln.strip() for ln in rep.splitlines()
                     if "registers" in ln or "spill" in ln or "wgmma" in ln or "arning" in ln]
            print(f"ptxas {name}: " + " | ".join(lines), flush=True)
    libs = {name: ctypes.CDLL(out) for name, (_, out, _) in jobs.items()}
    if "parent" in libs:
        fn = libs["parent"].fused_actor_critic_wgmma_forward
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, ctypes.POINTER(p), p, p, p, i, p]
        fn.restype = i
    return {name: lib if name in ("mma_loop", "parent") else fac.bind(lib)
            for name, lib in libs.items()}


def forward(libs, name, w, obs, mask, with_value=True, prepared=None, mode=None):
    """Variant `name`'s forward through the wrapper, in `mode` (the one B
    derives unless given): (logits, value)."""
    from splendax_torch.ops import fused_actor_critic as fac

    return fac._launch("wgmma", w, obs, mask, with_value, prepared, lib=libs[name], mode=mode)


def parent_forward(lib, w, obs, mask, with_value, prepared):
    """The parent tree's wgmma kernel on prepared weights: (logits, value)."""
    import torch

    from splendax_torch.ops import fused_actor_critic as fac

    B = obs.shape[0]
    logits = torch.empty((B, 45), dtype=torch.float32, device=obs.device)
    value = torch.empty((B,), dtype=torch.float32, device=obs.device) if with_value else None
    err = lib.fused_actor_critic_wgmma_forward(
        obs.data_ptr(), mask.data_ptr(), B, w[0].shape[1], fac._ptrs(w), prepared.data_ptr(),
        logits.data_ptr(), value.data_ptr() if with_value else None, 0, fac._stream(obs))
    assert err == 0, f"the parent's kernel failed: CUDA error {err}"
    return logits, value


def share(got, want) -> float:
    """max |got - want| as a share of the rtol/atol 1e-5 tolerance."""
    got, want = got.double(), want.double()
    return ((got - want).abs() / (1e-5 + 1e-5 * want.abs())).max().item()


def random_weights(H, seed, device):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    out = []
    for n_out in (45, 1):
        for fi, fo in ((297, H), (H, H), (H, n_out)):
            bound = 1.0 / np.sqrt(fi)
            out.append(torch.as_tensor(rng.uniform(-bound, bound, (fi, fo)).astype(np.float32),
                                       device=device))
            out.append(torch.as_tensor(rng.uniform(-bound, bound, (fo,)).astype(np.float32),
                                       device=device))
    return out


def checks(libs: dict, nets: dict, obs_all, mask_all) -> None:
    """The correctness checks of --check (and of the full run)."""
    import numpy as np
    import torch

    from splendax_torch.ops import fused_actor_critic as fac

    dev = obs_all.device
    worst = dict.fromkeys(fac.launches_by_mode, 0.0)
    for H in (37, 100, 256, 768):
        w = random_weights(H, H, dev)
        w64 = [t.double() for t in w]
        rng = np.random.RandomState(H)
        for B in (1, 63, 64, 65, 4097):
            obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=dev)
            mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=dev)
            mask[0] = False
            for with_value in (True, False):
                ref = fac.fused_masked_forward_plain(w64, obs, mask, with_value)
                got = {m: forward(libs, "wgmma", w, obs, mask, with_value, mode=m) for m in worst}
                torch.cuda.synchronize()
                for m, out in got.items():
                    for g, r, t in zip(out, ref, got["tile"]):
                        if g is None:
                            continue
                        assert torch.isfinite(g).all(), f"wgmma {m} non-finite at H={H} B={B}"
                        assert torch.equal(g, t), f"wgmma {m} differs from tile at H={H} B={B}"
                        worst[m] = max(worst[m], share(g, r))
        prepared = fac.prepare_weights(w, True, libs["wgmma"])
        assert torch.equal(prepared, fac.prepare_weights_plain(w)), f"prep differs at H={H}"
    print("random weights, H in (37, 100, 256, 768), B in (1, 63, 64, 65, 4097), with and "
          "without value, share of rtol/atol 1e-5 vs float64: "
          + ", ".join(f"{m} {v:.3f}" for m, v in worst.items())
          + "; the modes bit-equal; prep equals prepare_weights_plain bit for bit", flush=True)
    for H, w in nets.items():
        w64 = [t.double() for t in w]
        obs, mask = obs_all[:8192].contiguous(), mask_all[:8192].contiguous()
        ref = fac.fused_masked_forward_plain(w64, obs, mask)
        f32 = fac.fused_masked_forward_plain(w, obs, mask)
        whole = forward(libs, "wgmma", w, obs, mask)
        s64 = max(share(g, r) for g, r in zip(whole, ref))
        s32 = max(share(g, r) for g, r in zip(whole, f32))
        line = [f"wgmma {s64:.3f} ({s32:.3f} vs float32)"]
        for m in fac.launches_by_mode:
            same = all(torch.equal(a, b)
                       for a, b in zip(forward(libs, "wgmma", w, obs, mask, mode=m), whole))
            line.append(f"{m} mode bit-equal {same}")
            assert same, f"the {m} mode differs at H={H}"
        for cut in (1000, 4096):
            parts = [forward(libs, "wgmma", w, obs[a:b].contiguous(), mask[a:b].contiguous())
                     for a, b in ((0, cut), (cut, 8192))]
            same = all(torch.equal(torch.cat([p[j] for p in parts]), whole[j]) for j in (0, 1))
            line.append(f"split {cut}+{8192 - cut} bit-equal {same}")
            assert same, f"rows depend on B at H={H}"
        print(f"committed net H={H}, B=8192, share of the tolerance vs float64: "
              + "; ".join(line), flush=True)


def wide_probe(libs, cs, dev) -> None:
    """--wide: the wide route's checks and split."""
    import torch

    from splendax_torch.ops import fused_actor_critic as fac

    obs_all, mask_all = cs.realistic_obs(8192, 30, seed=1024, device=dev)
    for H in (1024, 1280, 2048):
        w = random_weights(H, H, dev)
        w64 = [t.double() for t in w]
        worst = 0.0
        for B in (1, 65, 8192):
            obs, mask = obs_all[:B].contiguous(), mask_all[:B].contiguous()
            for with_value in (True, False):
                got = {m: fac._launch("wide", w, obs, mask, with_value, lib=libs["wgmma"], mode=m)
                       for m in fac.launches_by_wide_mode}
                ref = fac.fused_masked_forward_plain(w64, obs, mask, with_value)
                assert all(a is None or torch.equal(a, b)
                           for a, b in zip(got["pass"], got["half"])), \
                    f"wide modes differ at H={H} B={B}"
                for g, r in zip(got["pass"], ref):
                    if g is not None:
                        assert torch.isfinite(g).all(), f"wide non-finite at H={H} B={B}"
                        worst = max(worst, share(g, r))
        assert worst <= 1.0, f"wide route at H={H}: {worst:.3f} of the tolerance"
        print(f"wide route H={H}: {worst:.3f} of rtol/atol 1e-5 vs float64 (B in 1, 65, 8192, "
              f"with and without value; both modes, bit-equal)", flush=True)
    for H in (1024, 1280):
        w = random_weights(H, H, dev)
        for with_value in (True, False):
            for B in (16, 256, 512, 1024, 2048, 4096):
                obs, mask = obs_all[:B].contiguous(), mask_all[:B].contiguous()
                x32 = obs.float()
                prepared = fac.prepare_weights(w, with_value, libs["wgmma"])
                out = {m: cs.device_ms(lambda: fac._launch("wide", w, obs, mask, with_value,
                                                           prepared, lib=libs["wgmma"], mode=m),
                                       20, per_call=3)[0]
                       for m in fac.launches_by_wide_mode}

                def addmm_chain():
                    for o in ((0, 6) if with_value else (0,)):
                        h = torch.tanh(torch.addmm(w[o + 1], x32, w[o]))
                        h = torch.tanh(torch.addmm(w[o + 3], h, w[o + 2]))
                        torch.addmm(w[o + 5], h, w[o + 4])

                out["addmm chain"] = cs.device_ms(addmm_chain, 20)[0]
                print(f"wide modes B={B} H={H} value={with_value} (the path's: "
                      f"{fac.wide_mode(B, H, with_value)}): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
                      + " ms", flush=True)
    names = ("wgmma", "wgmma_one_product") + WGMMA_SPLIT
    for H, B, with_value in ((1024, 1024, True), (1024, 1024, False), (1024, 8192, True),
                             (1280, 8192, True)):
        w = random_weights(H, H, dev)
        obs, mask = obs_all[:B].contiguous(), mask_all[:B].contiguous()
        x32 = obs.float()
        out = {}
        for name in names:
            prepared = fac.prepare_weights(w, with_value, libs[name])
            out[name.replace("wgmma", "wide")] = cs.device_ms(
                lambda: fac._launch("wide", w, obs, mask, with_value, prepared, lib=libs[name]),
                20, per_call=3)[0]
        prepared = fac.prepare_weights(w, with_value, libs["wgmma"])
        kernels = cs.profiled_kernels(lambda: [fac._launch("wide", w, obs, mask, with_value,
                                                           prepared, lib=libs["wgmma"])
                                               for _ in range(20)], min_launches=60)
        parts = {("outputs" if "wide_heads" in e.key else "layer 1"
                  if "<1," in e.key or "Li1E" in e.key else "layer 2"):
                 e.self_device_time_total / 1e3 / 20 for e in kernels}

        def addmm_chain():
            for o in ((0, 6) if with_value else (0,)):
                h = torch.tanh(torch.addmm(w[o + 1], x32, w[o]))
                h = torch.tanh(torch.addmm(w[o + 3], h, w[o + 2]))
                torch.addmm(w[o + 5], h, w[o + 4])

        out["addmm chain"] = cs.device_ms(addmm_chain, 20)[0]
        bound = cs.bound_a(B, H, with_value, 2)[0]
        mode = fac.wide_mode(B, H, with_value)
        grids = fac.wide_launch_shape(B, H, with_value, mode)
        print(f"wide route B={B} H={H} value={with_value} (bound {bound:.4f} ms; {mode} "
              f"mode, grids: layers {grids['layers']}, outputs {grids['heads']}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in out.items()) + " ms; by launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + " ms", flush=True)


def main() -> int:
    import torch

    args = sys.argv[1:]
    check = "--check" in args
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from splendax_torch.models import actor_critic as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from splendax_torch.ops import fused_actor_critic as fac

    wide = "--wide" in args
    libs = build(check, parent, wide)

    dev = torch.device("cuda")
    if wide:
        wide_probe(libs, cs, dev)
        return 0
    nets = {H: ac.kernel_weights(ac.import_params_npz(os.path.join(ROOT, src), device=dev))
            for H, src in ((256, "runs/ppo_splendor_2b/ppo_splendor_params.npz"),
                           (768, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"))}
    obs_all, mask_all = cs.realistic_obs(32768, 30, seed=768, device=dev)
    checks(libs, nets, obs_all, mask_all)

    w, H = nets[768], 768

    def addmm_chain(x32, with_value):
        for o in ((0, 6) if with_value else (0,)):
            h = torch.tanh(torch.addmm(w[o + 1], x32, w[o]))
            h = torch.tanh(torch.addmm(w[o + 3], h, w[o + 2]))
            torch.addmm(w[o + 5], h, w[o + 4])

    def timings(B, with_value, obs_src, mask_src, names=("wgmma",), n=20):
        obs, mask = obs_src[:B].contiguous(), mask_src[:B].contiguous()
        x32 = obs.float()
        out = {}
        for name in names:
            prepared = fac.prepare_weights(w, with_value, libs[name])
            for m in fac.launches_by_mode:
                out[f"{name} {m}"] = cs.device_ms(
                    lambda: forward(libs, name, w, obs, mask, with_value, prepared, m), n)[0]
        for m in fac.launches_by_mode:
            out[f"wgmma {m} (prep + kernel)"] = cs.device_ms(
                lambda: forward(libs, "wgmma", w, obs, mask, with_value, mode=m), n)[0]
        out["prep"] = cs.device_ms(lambda: fac.prepare_weights(w, with_value, libs["wgmma"]),
                                   n)[0]
        out["addmm chain"] = cs.device_ms(lambda: addmm_chain(x32, with_value), n)[0]
        bound = cs.bound_a(B, H, with_value, 2)[0]
        print(f"B={B} H={H} value={with_value} (bound {bound:.4f} ms; the path's mode "
              f"{fac.wgmma_mode(B, H)}): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
              + " ms", flush=True)

    def clocks(B, with_value, name="wgmma_clocks"):
        """The cluster mode's steps at B rows, from a clocks variant."""
        import numpy as np

        obs, mask = obs_all[:B].contiguous(), mask_all[:B].contiguous()
        for _ in range(3):  # warm
            logits, _ = forward(libs, name, w, obs, mask, with_value, mode="cluster")
        torch.cuda.synchronize()
        grid = fac.launch_shape(B, H, with_value, "cluster")[0]
        n = grid[0] * grid[1] * grid[2]
        t = logits.flatten().view(torch.int64)[:13 * n].view(n, 13).cpu().numpy()
        t = t - t[:, :1].min()
        steps = np.concatenate([np.diff(t[:, :10], axis=1),
                                t[:, [10, 11, 7, 12, 10]] - t[:, [6, 10, 11, 6, 12]]], axis=1) / 1e3
        print(f"cluster mode clocks ({name}) B={B} value={with_value}: {n} blocks, span "
              f"{(t[:, 9].max()) / 1e3:.1f} us, block starts at "
              + "/".join(f"{np.percentile(t[:, 0], q) / 1e3:.1f}" for q in (0, 50, 90, 100))
              + " us (min/median/p90/max); median us per step: "
              + ", ".join(f"{k} {v:.2f}" for k, v in zip(STEPS, np.median(steps, axis=0))),
              flush=True)

    def against_parent(B, with_value, obs_src, mask_src, n=20):
        """The parent's kernel and this tree's tile mode in turns, same rows."""
        obs, mask = obs_src[:B].contiguous(), mask_src[:B].contiguous()
        prepared = fac.prepare_weights(w, with_value)
        run = {"parent": lambda: parent_forward(libs["parent"], w, obs, mask, with_value, prepared),
               "tile": lambda: forward(libs, "wgmma", w, obs, mask, with_value, prepared, "tile")}
        ms = [(k, cs.device_ms(run[k], n)[0])
              for k in ("parent", "tile", "tile", "parent", "parent", "tile")]
        print(f"B={B} H={H} value={with_value}, in turns: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms) + " ms", flush=True)

    print(f"cluster mode at H={H}: {fac.max_clusters(H)} clusters of {fac.column_groups(H)} "
          f"blocks resident at once", flush=True)
    if parent is not None:
        obs_big, mask_big = cs.realistic_obs(737280, 30, seed=768, device=dev)
        for B, with_value in ((8192, True), (32768, True), (737280, True), (2048, False)):
            big = B > 32768
            against_parent(B, with_value, obs_big if big else obs_all,
                           mask_big if big else mask_all, n=5 if big else 20)
        del obs_big, mask_big
    for B, with_value in ((64, False), (2048, False), (8192, True)):
        clocks(B, with_value)
    for name in CLOCKS[1:]:
        clocks(64, False, name)
    if check:
        for B, with_value in ((1, False), (256, False), (512, False), (1024, False),
                              (2048, False), (3072, False), (4096, True)):
            timings(B, with_value, obs_all, mask_all)
        timings(8192, True, obs_all, mask_all, names=("wgmma",) + WGMMA_SPLIT)
        return 0

    for B in (8192, 32768):
        timings(B, True, obs_all, mask_all,
                names=tuple(n for n in WGMMA_VARIANTS if n not in CLOCKS))
    timings(8192, False, obs_all, mask_all)
    timings(32768, False, obs_all, mask_all)
    for B, with_value in ((1, False), (256, False), (512, False), (1024, False), (2048, False),
                          (3072, False), (4096, True)):
        timings(B, with_value, obs_all, mask_all)
    obs_big, mask_big = cs.realistic_obs(737280, 30, seed=768, device=dev)
    for with_value in (True, False):
        timings(737280, with_value, obs_big, mask_big, n=5)
    del obs_big, mask_big

    run = libs["mma_loop"].run
    run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device=dev)
    iters = 4000
    ms = cs.device_ms(lambda: run(sms, iters, out.data_ptr()), 5)[0]
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.split()[0])
    products = sms * 8 * iters * 8
    print(f"mma.sync m16n8k8 TF32: {products / (ms * 1e-3) / sms / (mhz * 1e6):.3f} products "
          f"per SM clock at the {mhz:.0f} MHz maximum = "
          f"{products * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12:.1f} TFLOP/s "
          f"(8 warps per SM, 8 independent accumulators each)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where kernel A's time goes on one GPU: variants of both its routes' sources,
their times beside the `addmm` chain, and the tensor cores' mma.sync TF32 rate.

    python3 scripts/torch_kernel_a_probe.py            # everything below, ~2 min
    python3 scripts/torch_kernel_a_probe.py --check    # build, check, one timing; ~1 min

Builds variants of `splendax_torch/csrc/fused_actor_critic_wgmma.cu` (the
`wgmma` route, H <= 768) and `fused_actor_critic.cu` (the `mma_sync` route,
PR 2's kernel) with nvcc (sm_90a, the flags of `splendax_torch/ops/_build.py`)
under `build/probe/`, each with the probe switches its source documents, and
times each on the device clock as chip_smoke.py's kernel phase does, with the
committed h768 net on engine obs.  Prints the card's name and power limit
first, and each new variant's ptxas report (registers, spills, and any
wgmma serialisation warning).

--check: the `wgmma` route against the float64 plain forward (rtol/atol
1e-5) on seeded random weights at H = 37, 100, 256, 768 and B = 1, 63, 64,
65, 4097, and on the committed h256 and h768 nets at B = 8192; the prep
kernel against `prepare_weights_plain` bit for bit; rows independent of B
(1,000 + 7,192 and 4,096 + 4,096 against 8,192); then one timing at B = 8192
with value, with the no_loads variants beside it.  Every variant is called
through the wrapper (`fused_actor_critic._launch` with the variant's
library), as the path calls the library's own build.

Without --check, after the checks:

  wgmma route, B = 8192, 32768, 737280, with and without value: the kernel
  (weights prepared once), the prep kernel alone, the route as the wrapper
  runs it (prep + kernel), PR 2's kernel, the addmm chain;
  variants at B = 8192 and 32768 with value:
  one_product      one TF32 product per f32 one (wrong numbers: the same
                   loads with a third of the tensor work);
  no_loads         no weight stage is ever copied (wrong numbers: the
                   compute alone);
  no_loads_one     both;
  B = 1, 256, 1024, 2048, 3072 without value and 4096 with it (the host
  policies, the eval, the root prior, the pool slots, a dp=2 rank): both
  routes and the addmm chain;
  PR 2's variants at B = 8192 with value (one_product, no_loads,
  no_loads_one) and its mma.sync TF32 rate per SM clock.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe")
MMA_SYNC_VARIANTS = {
    "kernel": (),
    "one_product": ("-DPROBE_ONE_PRODUCT",),
    "no_loads": ("-DPROBE_NO_LOADS",),
    "no_loads_one": ("-DPROBE_NO_LOADS", "-DPROBE_ONE_PRODUCT"),
}
WGMMA_VARIANTS = {
    "wgmma": (),
    "wgmma_one_product": ("-DPROBE_ONE_PRODUCT",),
    "wgmma_no_loads": ("-DPROBE_NO_LOADS",),
    "wgmma_no_loads_one": ("-DPROBE_NO_LOADS", "-DPROBE_ONE_PRODUCT"),
}
# The compute alone: timed in --check too.
WGMMA_SPLIT = ("wgmma_no_loads", "wgmma_no_loads_one")

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


def build(check: bool) -> dict:
    """{name: loaded library} for every variant (with --check only the
    wgmma kernel, its no_loads variants and PR 2's kernel), each bound by the
    wrapper, and the mma loop; prints the wgmma variants' ptxas reports."""
    from splendax_torch.ops import _build
    from splendax_torch.ops import fused_actor_critic as fac

    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, flags in WGMMA_VARIANTS.items():
        if not check or name in ("wgmma",) + WGMMA_SPLIT:
            jobs[name] = (_build.CSRC / "fused_actor_critic_wgmma.cu",
                          os.path.join(OUT, f"lib{name}.so"), flags)
    for name, flags in MMA_SYNC_VARIANTS.items():
        if not check or name == "kernel":
            jobs[name] = (_build.CSRC / "fused_actor_critic.cu", os.path.join(OUT, f"lib{name}.so"),
                          flags)
    if not check:
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
    return {name: lib if name == "mma_loop" else fac.bind(lib, route_of(name))
            for name, lib in libs.items()}


def route_of(name: str) -> str:
    return "wgmma" if name.startswith("wgmma") else "mma_sync"


def forward(libs, name, w, obs, mask, with_value=True, prepared=None):
    """Variant `name`'s forward through the wrapper: (logits, value)."""
    from splendax_torch.ops import fused_actor_critic as fac

    return fac._launch(route_of(name), w, obs, mask, with_value, prepared, lib=libs[name])


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
    worst = 0.0
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
                got = forward(libs, "wgmma", w, obs, mask, with_value)
                torch.cuda.synchronize()
                for g, r in zip(got, ref):
                    if g is None:
                        continue
                    assert torch.isfinite(g).all(), f"wgmma non-finite at H={H} B={B}"
                    worst = max(worst, share(g, r))
        prepared = fac.prepare_weights(w, True, libs["wgmma"])
        assert torch.equal(prepared, fac.prepare_weights_plain(w)), f"prep differs at H={H}"
    print("random weights, H in (37, 100, 256, 768), B in (1, 63, 64, 65, 4097), with and "
          f"without value, share of rtol/atol 1e-5 vs float64: wgmma {worst:.3f}; prep equals "
          "prepare_weights_plain bit for bit", flush=True)
    for H, w in nets.items():
        w64 = [t.double() for t in w]
        obs, mask = obs_all[:8192].contiguous(), mask_all[:8192].contiguous()
        ref = fac.fused_masked_forward_plain(w64, obs, mask)
        f32 = fac.fused_masked_forward_plain(w, obs, mask)
        whole = forward(libs, "wgmma", w, obs, mask)
        s64 = max(share(g, r) for g, r in zip(whole, ref))
        s32 = max(share(g, r) for g, r in zip(whole, f32))
        line = [f"wgmma {s64:.3f} ({s32:.3f} vs float32)"]
        for cut in (1000, 4096):
            parts = [forward(libs, "wgmma", w, obs[a:b].contiguous(), mask[a:b].contiguous())
                     for a, b in ((0, cut), (cut, 8192))]
            same = all(torch.equal(torch.cat([p[j] for p in parts]), whole[j]) for j in (0, 1))
            line.append(f"split {cut}+{8192 - cut} bit-equal {same}")
            assert same, f"rows depend on B at H={H}"
        print(f"committed net H={H}, B=8192, share of the tolerance vs float64: "
              + "; ".join(line), flush=True)


def main() -> int:
    import torch

    check = "--check" in sys.argv[1:]
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

    libs = build(check)

    dev = torch.device("cuda")
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
            out[name] = cs.device_ms(
                lambda: forward(libs, name, w, obs, mask, with_value, prepared), n)[0]
        out["wgmma route (prep + kernel)"] = cs.device_ms(
            lambda: forward(libs, "wgmma", w, obs, mask, with_value), n)[0]
        out["prep"] = cs.device_ms(lambda: fac.prepare_weights(w, with_value, libs["wgmma"]),
                                   n)[0]
        out["mma_sync (PR 2)"] = cs.device_ms(
            lambda: forward(libs, "kernel", w, obs, mask, with_value), n)[0]
        out["addmm chain"] = cs.device_ms(lambda: addmm_chain(x32, with_value), n)[0]
        bound = cs.bound_a(B, H, with_value, 2)[0]
        print(f"B={B} H={H} value={with_value} (bound {bound:.4f} ms): "
              + ", ".join(f"{k} {v:.4f}" for k, v in out.items()) + " ms", flush=True)

    if check:
        timings(8192, True, obs_all, mask_all, names=("wgmma",) + WGMMA_SPLIT)
        return 0

    for B in (8192, 32768):
        timings(B, True, obs_all, mask_all, names=tuple(WGMMA_VARIANTS))
    timings(8192, False, obs_all, mask_all)
    timings(32768, False, obs_all, mask_all)
    for B, with_value in ((1, False), (256, False), (1024, False), (2048, False), (3072, False),
                          (4096, True)):
        timings(B, with_value, obs_all, mask_all)
    obs_big, mask_big = cs.realistic_obs(737280, 30, seed=768, device=dev)
    for with_value in (True, False):
        timings(737280, with_value, obs_big, mask_big, n=5)
    del obs_big, mask_big

    obs, mask = obs_all[:8192].contiguous(), mask_all[:8192].contiguous()
    for name in ("one_product", "no_loads", "no_loads_one"):
        ms = cs.device_ms(lambda: forward(libs, name, w, obs, mask), 20)[0]
        print(f"mma_sync route variant {name}: {ms:.4f} ms (B=8192, H={H}, with value)",
              flush=True)
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

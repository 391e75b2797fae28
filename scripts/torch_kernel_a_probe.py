#!/usr/bin/env python3
"""Where kernel A's time goes on one GPU: variants of its source, its row
tiles, and the tensor cores' mma.sync TF32 rate.

    python3 scripts/torch_kernel_a_probe.py

Builds variants of `splendax_torch/csrc/fused_actor_critic.cu` with nvcc
(sm_90a, the flags of `splendax_torch/ops/_build.py`) under `build/probe/`,
each with the probe switches the source documents, and times each as
chip_smoke.py's kernel phase does, on the device clock, with the committed
h768 net on engine obs:

  at the agent forward (B = 8192, H = 768, with value):
  kernel           the kernel as committed;
  l1_three         the same kernel on obs with one value of 4097 in every
                   16 rows, so every block takes layer 1's third product;
  one_product      one TF32 product per f32 one and no split (wrong numbers:
                   the same loads and tile with a third of the tensor work);
  no_loads         no weight tile is ever copied into shared memory (wrong
                   numbers: the compute alone);
  no_loads_one     both;

  at the agent and pool-slot shapes (B = 8192 with value; 2048 and 3072
  without): the kernel's own row tile beside 16- and 32-row tiles.

Then it times a loop of independent `mma.sync.m16n8k8` TF32 products (one
block of 8 warps per SM, 8 accumulators per warp) and prints their rate per
SM clock.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe")
VARIANTS = {
    "kernel": (),
    "one_product": ("-DPROBE_ONE_PRODUCT",),
    "no_loads": ("-DPROBE_NO_LOADS",),
    "no_loads_one": ("-DPROBE_NO_LOADS", "-DPROBE_ONE_PRODUCT"),
    "rows16": ("-DPROBE_ROWS=16",),
    "rows32": ("-DPROBE_ROWS=32",),
}

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


def build() -> dict:
    """{name: loaded library} for every variant and the mma loop."""
    from splendax_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    loop_cu = os.path.join(OUT, "mma_loop.cu")
    with open(loop_cu, "w") as f:
        f.write(MMA_LOOP)
    src = _build.CSRC / "fused_actor_critic.cu"
    jobs = {name: (src, os.path.join(OUT, f"lib{name}.so"), flags)
            for name, flags in VARIANTS.items()}
    jobs["mma_loop"] = (loop_cu, os.path.join(OUT, "libmma_loop.so"), ())
    _build.compile_many(jobs)
    return {name: ctypes.CDLL(out) for name, (_, out, _) in jobs.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from splendax_torch.models import actor_critic as ac

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build()

    dev = torch.device("cuda")
    H = 768
    w = ac.kernel_weights(ac.import_params_npz(
        os.path.join(ROOT, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"), device=dev))
    obs_all, mask_all = cs.realistic_obs(8192, 30, seed=H, device=dev)
    big = obs_all.clone()
    big[::16, 0] = 4097  # not exact in TF32: every block takes all three layer-1 products
    ptrs = (ctypes.c_void_p * 12)(*[t.data_ptr() for t in w])

    def time_variant(name, B, with_value, obs=obs_all):
        fn = libs[name].fused_actor_critic_forward
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        x, m = obs[:B].contiguous(), mask_all[:B].contiguous()
        logits = torch.empty((B, 45), device=dev)
        value = torch.empty((B,), device=dev) if with_value else None

        def call():
            err = fn(x.data_ptr(), m.data_ptr(), B, H, ptrs, logits.data_ptr(),
                     value.data_ptr() if with_value else None,
                     torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"{name}: CUDA error {err}"

        return cs.device_ms(call, 20)[0]

    for name, obs in (("kernel", obs_all), ("l1_three", big), ("one_product", obs_all),
                      ("no_loads", obs_all), ("no_loads_one", obs_all)):
        ms = time_variant("kernel" if name == "l1_three" else name, 8192, True, obs)
        print(f"kernel A variant {name}: {ms:.4f} ms (B=8192, H={H}, with value)", flush=True)
    for B, with_value in ((8192, True), (2048, False), (3072, False)):
        own, r16, r32 = (time_variant(n, B, with_value) for n in ("kernel", "rows16", "rows32"))
        print(f"kernel A row tiles B={B} value={with_value}: own choice {own:.4f} ms, "
              f"16 rows {r16:.4f} ms, 32 rows {r32:.4f} ms", flush=True)

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

#!/usr/bin/env python3
"""Kernel A's error against its plain versions on one GPU, as shares of the
rtol/atol 1e-5 tolerance, at every B that chip_smoke.py's kernel phase and
the distillation shapes give it.

    python3 scripts/torch_kernel_a_shares.py

For both committed nets (H = 256 and 768) and two sets of engine obs (the
first B of 92,160 and of 737,280 games after 30 random plies, as
chip_smoke.realistic_obs deals them), prints for each B, with and without
value, and for the logits and the value: kernel vs the float64 plain
forward, the float32 plain forward vs float64, and kernel vs float32.
Prints the card's name and power limit first.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B_ALL = (1, 17, 32, 64, 256, 257, 1024, 2048, 3072, 8192, 24576, 32768, 92160, 184320, 737280)
NETS = ((256, "runs/ppo_splendor_2b/ppo_splendor_params.npz"),
        (768, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"))


def share(got, want) -> float:
    """max |got - want| as a share of the rtol/atol 1e-5 tolerance."""
    got, want = got.double(), want.double()
    return ((got - want).abs() / (1e-5 + 1e-5 * want.abs())).max().item()


def main() -> int:
    import torch

    import chip_smoke as cs
    from splendax_torch.models import actor_critic as ac
    from splendax_torch.ops import _build
    from splendax_torch.ops import fused_actor_critic as fac

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    _build.timed_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    for H, src in NETS:
        w = ac.kernel_weights(ac.import_params_npz(os.path.join(ROOT, src), device=dev))
        w64 = [t.double() for t in w]
        for n_all in (92160, 737280):
            obs_all, mask_all = cs.realistic_obs(n_all, 30, seed=H, device=dev)
            for B in (b for b in B_ALL if b <= n_all):
                obs, mask = obs_all[:B].contiguous(), mask_all[:B].contiguous()
                for v in (True, False):
                    outs = [fac.fused_masked_forward(w, obs, mask, v),
                            fac.fused_masked_forward_plain(w, obs, mask, v),
                            fac.fused_masked_forward_plain(w64, obs, mask, v)]
                    for name, got, f32, ref in zip(("logits", "value"), *outs):
                        if got is None:
                            continue
                        print(f"H={H} data={n_all} B={B} value={v} {name}: kernel~f64 "
                              f"{share(got, ref):.3f} f32~f64 {share(f32, ref):.3f} kernel~f32 "
                              f"{share(got, f32):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

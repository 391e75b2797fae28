"""The readings the limits of `benchmark/limits/` are set from: for each seed,
a cell's set-up, the operations up to those the check follows, and the check, in
one process so the kernels are built once.

    python -m benchmark.readings --workload <cell> --seeds 1 2 3 ... \
        [--controls 3] [--stale-prep] [--out chiprun_out/readings.jsonl]

Each seed prints one JSON line: the program's numbers; for the first
`--controls` seeds also the control's (the reference in float32 with TF32
products put in the program's place, `reference/model.py`) and, for an
update cell, the planted faults' (`reference/follow.FAULTS`: the state left
unchanged, half of each minibatch left out with the mean over the rest, the
answers altered where they are made).  An update cell's seeds run the
window's updates up to the one the check follows.  `--stale-prep` plants a
fault in the program itself for every seed: kernel A's prepared weights are
never prepared again once made, so from the second update on the CURRENT
slot's forwards run the warm-up's weights; its lines are the fault's
readings, not sound ones.  A limit lies above every sound reading and below
the control's and the faults' (PERF.md gives both).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402
from benchmark.harness import log  # noqa: E402
from benchmark.reference import follow  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--stale-prep", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not harness.cuda_ready(cell["chips"]):
        log("readings: no CUDA device")
        return 2
    import torch

    log(f"readings: {args.workload}; {harness.power_limit()}")
    if args.stale_prep:
        from splendax_torch.ops.fused_actor_critic import PreparedWeights

        PreparedWeights.stale = lambda self: self._buffer is None
    kind = cell["traffic"]["kind"]
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        run = harness.driver(kind).Run(cell, seed, "cuda")
        run.build_kernels()
        run.warm()
        run.finish()
        run.release()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        controls = ("tf32",) if i < args.controls else ()
        faults = follow.FAULTS if i < args.controls else ()
        numbers = run.check(controls, faults)
        line = {"workload": args.workload, "seed": seed, "stale_prep": args.stale_prep, **numbers,
                "seconds": {"run": t1 - t0, "check": time.perf_counter() - t1}}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del run
    if harness.forbidden_modules():
        log("readings: JAX or the JAX package is loaded:", harness.forbidden_modules())
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

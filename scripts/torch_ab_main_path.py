#!/usr/bin/env python3
"""Two trees' main path on one GPU, in turns: chip_smoke.py's env, rollout,
update and league phases of each tree, each side in a process of its own.

    python3 scripts/torch_ab_main_path.py PARENT_TREE CHANGE_TREE [PHASE ...]

Runs parent, change, change, parent (each tree builds its own kernels under
its `build/`), and prints each phase's rate line under a header naming the
side, after the card's name and power limit.  PHASE names a subset of env,
rollout, update and league (all four by default).  Unpack the parent with `git
archive <commit> | tar -x -C <dir>` inside a directory .gitignore lists.
"""

import re
import subprocess
import sys

SIDE = r"""
import os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from splendax_torch.ops import _build
_build.timed_build()
dev = torch.device("cuda", 0)
for phase in sys.argv[2:]:
    getattr(cs, "phase_" + phase)(dev)
"""
KEEP = re.compile(r"(env:|rollout:|update: \d|league update|league rollout)")


def main() -> int:
    phases = sys.argv[3:] or ["env", "rollout", "update", "league"]
    if len(sys.argv) < 3 or not set(phases) <= {"env", "rollout", "update", "league"}:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = sys.argv[1:3]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for side, tree in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", SIDE, tree] + phases, capture_output=True,
                             text=True)
        print(f"== {side} ({tree}) rc={out.returncode}", flush=True)
        for line in out.stdout.splitlines():
            if KEEP.match(line):
                print(line[:230], flush=True)
        if out.returncode:
            print(out.stderr[-2000:], flush=True)
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Two trees' main path on one GPU, in turns: chip_smoke.py's rollout,
update and league phases of each tree, each side in a process of its own,
and the bench's update workload without and with its search slot.

    python3 scripts/torch_ab_main_path.py PARENT_TREE CHANGE_TREE [PHASE ...]

Runs parent, change, change, parent (each tree builds its own kernels under
its `build/`), and prints each phase's rate line under a header naming the
side, after the card's name and power limit.  PHASE names a subset of
rollout, update and league (all three by default), and bench_none and
bench_static: `python -m splendax_torch.bench --workload update --slot none`
(or static) run in the tree, of whose JSON line the rate, the reps, the peak
memory, kernel A's launches and weight preparations an update are printed.
Unpack the parent with `git archive <commit> | tar -x -C <dir>` inside a
directory .gitignore lists.
"""

import json
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
KEEP = re.compile(r"(rollout:|update: \d|league update|league rollout)")
PHASES = {"rollout", "update", "league"}
BENCH = {"bench_none": "none", "bench_static": "static"}


def bench_line(tree: str, slot: str) -> str:
    """The bench's update workload with `slot` in `tree`, summarised."""
    out = subprocess.run([sys.executable, "-m", "splendax_torch.bench", "--workload", "update",
                          "--slot", slot], cwd=tree, capture_output=True, text=True)
    if out.returncode:
        return f"bench {slot}: rc={out.returncode}\n{out.stderr[-2000:]}"
    line = json.loads(out.stdout.splitlines()[-1])
    n = line["launches_per_update"]
    return (f"bench {slot}: best {line['value']} agent steps/s, mean {line['mean']}, seconds "
            f"{line['seconds_per_rep']}, steps {line['optimizer_steps_per_rep']}, peak "
            f"{line['peak_memory_bytes']} bytes, kernel A {n['fused_actor_critic']} (tile "
            f"{n['fused_actor_critic_tile']}, cluster {n['fused_actor_critic_cluster']}), "
            f"preparations {n['fused_actor_critic_prep']} an update, prepared "
            f"{line.get('prepared_bytes', '-')} bytes, split {line['split_seconds']}")


def main() -> int:
    phases = sys.argv[3:] or sorted(PHASES)
    if len(sys.argv) < 3 or not set(phases) <= PHASES | set(BENCH):
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = sys.argv[1:3]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    smoke = [p for p in phases if p in PHASES]
    for side, tree in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        print(f"== {side} ({tree})", flush=True)
        if smoke:
            out = subprocess.run([sys.executable, "-c", SIDE, tree] + smoke, capture_output=True,
                                 text=True)
            for line in out.stdout.splitlines():
                if KEEP.match(line):
                    print(line[:230], flush=True)
            if out.returncode:
                print(f"rc={out.returncode}\n{out.stderr[-2000:]}", flush=True)
                return out.returncode
        for p in phases:
            if p in BENCH:
                print(bench_line(tree, BENCH[p]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""dp=2 training of the port through torchrun on this host, with one writer.

    python3 scripts/torch_torchrun_dp2.py [LOG_DIR]

Starts `python -m torch.distributed.run --standalone --nproc-per-node 2 -m
splendax_torch.train.train --dp 2` at 1024 games x 16 turns, H=256, 4 updates
with an eval every 2 (on one card the two ranks share it over gloo), then
checks that every rank started, that the mesh was dp=2, and that
`metrics.jsonl` holds each update once (two writers would log it twice) and
the npz export exists.  Prints the card's name and power limit, the ranks'
backend lines and one JSON line: the run's seconds, updates and backend.
LOG_DIR defaults to build/run_dp2 (its .pt files are ~21 MB).
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

UPDATES, GAMES, TURNS = 4, 1024, 16


def main(argv) -> None:
    log_dir = argv[0] if argv else os.path.join("build", "run_dp2")
    shutil.rmtree(log_dir, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "splendax_torch.train.train", "--dp", "2",
           "--total-timesteps", str(UPDATES * GAMES * TURNS), "--num-envs", str(GAMES),
           "--num-steps", str(TURNS), "--hidden", "256", "--eval-games", "32",
           "--eval-every-updates", "2", "--log-dir", log_dir]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    out = run.stdout + run.stderr
    if run.returncode != 0:
        sys.exit(f"torchrun exited {run.returncode}:\n{out[-6000:]}")
    starts = re.findall(r"\[multihost\] rank (\d+) of 2, backend (\w+)", out)
    for r, backend in sorted(starts):
        print(f"[multihost] rank {r} of 2, backend {backend}")
    if sorted(r for r, _ in starts) != ["0", "1"]:
        sys.exit(f"expected ranks 0 and 1 to start:\n{out[-6000:]}")
    if "[mesh] dp=2 tp=1" not in out:
        sys.exit(f"no dp=2 mesh line:\n{out[-6000:]}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        steps = [json.loads(x)["step"] for x in f if '"type": "train"' in x]
    if len(steps) != UPDATES or len(set(steps)) != UPDATES:
        sys.exit(f"metrics.jsonl logs steps {steps}: expected {UPDATES} updates, each once")
    if not os.path.exists(os.path.join(log_dir, "ppo_splendor_params.npz")):
        sys.exit("no npz export")
    print(json.dumps({"seconds": seconds, "updates": UPDATES, "games": GAMES, "turns": TURNS,
                      "hidden": 256, "backend": starts[0][1], "writer_lines": len(steps)}))


if __name__ == "__main__":
    main(sys.argv[1:])

"""Env-fleet throughput with the game batch split over ranks.

Counterpart of `bench_scaling.py`: the env pipeline (a uniform random legal
action, the step, the encode and the ring autoreset) with a fixed batch per
rank, on 1, 2, ... `--ranks` ranks of one process group, then the largest
total batch on one rank.  Prints one JSON line per world size and a summary
line: weak-scaling efficiency (the largest world's rate over world size x
one rank's) and the split's overhead (the largest world's rate over one
rank's on the same total batch).

Ranks on one card, or on the CPU, share it, so there the numbers measure
the port's overhead of splitting the batch (one all-reduce of the done
counts a step, through host memory on gloo), not scaling; the summary says
so.  With a card per rank they measure scaling.

    python -m splendax_torch.parallel.bench_scaling --ranks 2 --batch-per-rank 4096
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .multihost import spawn


def _fleet(batch_per_rank: int, steps: int, reps: int, device: str) -> dict:
    """Runs on every rank: `reps` timed runs of `steps` steps of this
    rank's games; returns the global env steps/s."""
    import torch.distributed as dist

    from ..env import core
    from ..env import ring as ring_lib
    from ..selfplay.opponents import uniform_legal_action
    from .multihost import global_mesh, local_device

    dev = local_device(device)
    mesh = global_mesh()
    n = batch_per_rank * mesh.dp
    lo, hi = mesh.row_range(n)
    g = torch.Generator(device=dev).manual_seed(0)  # the same stream on every rank
    state, _, mask = core.reset(n, g, dev)
    state, mask = state.map(mesh.rows), mesh.rows(mask)

    def run(k, ring):
        nonlocal state, mask
        for _ in range(k):
            u = torch.rand(n, generator=g, device=dev)[lo:hi]
            action = uniform_legal_action(mask, u=u)
            state, _, _, mask, ring = ring_lib.step_autoreset_ring(state, action, ring, mask=mask,
                                                                   mesh=mesh)
        return ring

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if dist.is_initialized():
            dist.barrier()

    run(2, ring_lib.make_ring(2 * n, g, dev, window=n))  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        ring = run(steps, ring_lib.make_ring(2 * n, g, dev, window=n))
    sync()
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"steps_per_sec": n * steps * reps / dt, "overflow": int(ring.overflow),
            "device": name}


def measure(world: int, batch_per_rank: int, steps: int, reps: int, device: str) -> dict:
    out = spawn(_fleet, world, args=(batch_per_rank, steps, reps, device), device=device)[0]
    if out["overflow"]:
        raise RuntimeError(f"ring window overflow: {out['overflow']} lanes")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch-per-rank", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default: the ranks share "
                    "this host's cards) or cpu")
    a = ap.parse_args(argv)
    lines, rates = [], {}
    for world in sorted({1, 2, a.ranks}):
        r = measure(world, a.batch_per_rank, a.steps, a.reps, a.device)
        rates[world] = r["steps_per_sec"]
        lines.append({"ranks": world, "batch": a.batch_per_rank * world,
                      "steps_per_sec": r["steps_per_sec"], "device": r["device"]})
        print(json.dumps(lines[-1]), flush=True)
    top = max(rates)
    whole = measure(1, a.batch_per_rank * top, a.steps, a.reps, a.device)["steps_per_sec"]
    cards = torch.cuda.device_count() if a.device != "cpu" else 0
    shared = cards < top
    lines.append({
        "metric": "weak_scaling_efficiency", "ranks": top,
        "value": rates[top] / (rates[1] * top),
        "split_overhead_ratio": rates[top] / whole,
        "one_rank_same_batch_sps": whole, "per_rank_batch": a.batch_per_rank,
        "device": lines[0]["device"], "cards": cards,
        "note": (f"{top} ranks share {cards or 'no'} card(s) ({a.device}): these numbers "
                 "measure the port's overhead of splitting the batch, not scaling"
                 if shared else ""),
    })
    print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()

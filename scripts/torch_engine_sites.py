"""The device time of the engine's plies by graph site, in one operation of
a benchmark cell.

    python3 scripts/torch_engine_sites.py [--cells CELL ...] [--seed N] [--calls N]

For each cell (default: `ac_h768.league_static` and `ac_h768.eval_gumbel`)
the script sets up as the benchmark does (`benchmark/drivers`), runs the
warm-up operation and one more, so that every graph of `env/graphed` is
captured, and counts the calls each site made in one further operation
(`graph.replay.<site>`, and every `graphed.call`, so that a site's eager
calls show too).  That operation is profiled: its device time in all.
Then each captured graph is timed alone: its call (the copies in, the
replay, the copies out) `--calls` times back to back under torch.profiler,
giving the device ms and the kernels of one call.  A site's device ms an
operation is the sum over its graphs of replays times ms a replay.

Prints a line per site and one JSON line per cell last.  Imports nothing of
JAX; run it on the card (it exits 1 without one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def kernel_events(run, top: list | None = None):
    """torch.profiler's device events over one call of `run`: (device ms,
    kernels), from the first of three sessions that sees device time; `top`
    receives (name, device ms, count) of the five longest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        ms = sum(e.self_device_time_total for e in ev) / 1e3
        if ms > 0:
            if top is not None:
                top.extend((e.key[:60], e.self_device_time_total / 1e3, e.count) for e in sorted(
                    ev, key=lambda e: -e.self_device_time_total)[:5])
            return ms, sum(e.count for e in ev)
    return 0.0, 0


def measure_cell(name: str, seed: int, n_calls: int) -> dict:
    import torch

    from benchmark import harness
    from splendax_torch import trace
    from splendax_torch.env import graphed

    cell = harness.load_cell(name)
    run = harness.driver(cell["traffic"]["kind"]).Run(cell, seed, "cuda")
    run.checked = set() if run.kind == "eval" else 10 ** 9  # no check's capture
    run.build_kernels()
    t0 = time.perf_counter()
    run.warm()
    run.op()
    torch.cuda.synchronize()
    print(f"{name}: warm-up and one operation in {time.perf_counter() - t0:.1f} s; "
          f"{len(graphed.captured())} graphs held", flush=True)

    calls: dict = {}
    call = graphed.call

    def counted(site, fn, *args, **kw):
        calls[site] = calls.get(site, 0) + 1
        return call(site, fn, *args, **kw)

    graphed.call = counted
    try:
        trace.zero("graph.")
        op_ms, op_kernels = kernel_events(run.op)
    finally:
        graphed.call = call
    n_calls_site = dict(calls)
    calls.clear()
    replays = {k[len("graph.replay."):]: v for k, v in trace.counters("graph.replay.").items()}

    sites: dict = {}
    for g in list(graphed._graphs.values()):
        leaves = [t.clone() for t in g.inputs]
        for _ in range(3):
            g(leaves)
        torch.cuda.synchronize()
        top: list = []
        ms, kernels = kernel_events(lambda: [g(leaves) for _ in range(n_calls)], top)
        row = sites.setdefault(g.site, {"graphs": []})
        row["graphs"].append({"shapes": [list(t.shape) for t in g.inputs[:1]],
                              "ms_a_replay": ms / n_calls, "kernels_a_replay": kernels / n_calls,
                              "top": [(k, t / n_calls, c / n_calls) for k, t, c in top]})
    total = 0.0
    for site, row in sorted(sites.items()):
        row["replays_an_op"] = replays.get(site, 0)
        row["calls_an_op"] = n_calls_site.get(site, 0)
        # A site's graphs share a shape in these cells; with more than one the
        # mean stands for each.
        mean_ms = sum(x["ms_a_replay"] for x in row["graphs"]) / len(row["graphs"])
        mean_k = sum(x["kernels_a_replay"] for x in row["graphs"]) / len(row["graphs"])
        row["ms_a_replay"], row["kernels_a_replay"] = mean_ms, mean_k
        row["ms_an_op"] = mean_ms * row["replays_an_op"]
        total += row["ms_an_op"]
        print(f"{name} {site}: {row['replays_an_op']} replays ({row['calls_an_op']} calls) an op, "
              f"{mean_ms:.4f} ms and {mean_k:.1f} kernels a replay, {row['ms_an_op']:.1f} ms an op "
              f"({len(row['graphs'])} graph(s): "
              + ", ".join(f"{x['shapes'][0]} {x['ms_a_replay']:.4f} ms" for x in row["graphs"])
              + ")", flush=True)
        for x in row["graphs"]:
            print("    " + "; ".join(f"{k} {t:.4f} ms x{c:.0f}" for k, t, c in x["top"]),
                  flush=True)
    print(f"{name}: the operation's device time {op_ms:.1f} ms in {op_kernels} kernels; the "
          f"graph sites {total:.1f} ms of it ({100 * total / max(op_ms, 1e-9):.1f}%)", flush=True)
    out = {"cell": name, "op_device_ms": op_ms, "op_kernels": op_kernels,
           "sites_ms_an_op": total, "sites": sites}
    run.release()
    graphed.reset()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=["ac_h768.league_static", "ac_h768.eval_gumbel"])
    ap.add_argument("--seed", type=int, default=2148500001)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_engine_sites: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for name in args.cells:
        print(json.dumps(measure_cell(name, args.seed, args.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the program's tracing (`splendax_torch.trace`) costs an update, in one
process on the card: a benchmark cell's update state (its set-up and warm-up,
`benchmark/drivers/update.py`), then updates back to back in turns of three
modes, each timed on the host clock to a synchronise:
  on      the program as it is (aggregates always on);
  off     `trace.span`, `count` and `sync` replaced by no-ops;
  record  the program under `trace.recording()` (a record of every span);
in the order on, off, record, record, off, on, `--rounds` times.  The
updates' own times spread by more than the tracing costs, so the script also
times the bookkeeping alone on the same host: `--reps` spans nested in pairs
under a root, and as many syncs of a call that does not block, each without
and under `recording()`, priced at the spans and syncs of one traced update.
Prints one JSON line: each mode's median seconds an update, the bookkeeping's
microseconds a span and a sync and its share of the `on` median, and the
last traced update's record.

    python3 scripts/torch_trace_cost.py --workload ac_h768.league_static --rounds 2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _NoSpan:
    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@contextlib.contextmanager
def tracing_off(trace):
    saved = trace.span, trace.count, trace.sync
    trace.span, trace.count, trace.sync = _NoSpan, (lambda name, n=1: None), (
        lambda site, fn: fn())
    try:
        yield
    finally:
        trace.span, trace.count, trace.sync = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="ac_h768.league_static")
    ap.add_argument("--seed", type=int, default=2147500101)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=100_000)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from splendax_torch import trace
    from splendax_torch.train import ppo

    cell = harness.load_cell(args.workload)
    if cell["traffic"]["kind"] != "update" or not torch.cuda.is_available():
        print("torch_trace_cost: needs an update cell and a CUDA device", file=sys.stderr)
        return 2
    run = harness.driver("update").Run(cell, args.seed, "cuda")
    run.build_kernels()
    run.warm()
    cfg, ts = run.cfg, run.ts
    modes = {"on": contextlib.nullcontext, "off": lambda: tracing_off(trace),
             "record": trace.recording}
    seconds = {m: [] for m in modes}
    spans = syncs = rec = None
    for _ in range(args.rounds):
        for m in ("on", "off", "record", "record", "off", "on"):
            n0 = len(trace.records("update"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with modes[m]():
                ts, _ = ppo.update_step(cfg, ts)
            torch.cuda.synchronize()
            seconds[m].append(time.perf_counter() - t0)
            if m == "on" and len(trace.records("update")) > n0:
                rec = trace.records("update")[-1]
                spans = sum(s["count"] for s in rec["spans"].values())
                syncs = sum(v for k, v in rec["counters"].items() if k.startswith("sync."))
    med = {m: statistics.median(s) for m, s in seconds.items()}
    book = {}
    for mode, ctx in (("on", contextlib.nullcontext), ("record", trace.recording)):
        with ctx(), trace.span("update"):
            t0 = time.perf_counter()
            for _ in range(args.reps // 2):
                with trace.span("a"), trace.span("b"):
                    pass
            t1 = time.perf_counter()
            with trace.span("a"), trace.span("b"):
                for _ in range(args.reps):
                    trace.sync("bookkeeping", int)
            t2 = time.perf_counter()
        book[mode] = {"us_per_span": (t1 - t0) / args.reps * 1e6,
                      "us_per_sync": (t2 - t1) / args.reps * 1e6}
        book[mode]["ms_per_update"] = (spans * book[mode]["us_per_span"]
                                       + syncs * book[mode]["us_per_sync"]) / 1e3
        book[mode]["pct_of_update"] = 100 * book[mode]["ms_per_update"] / 1e3 / med["on"]
    print(json.dumps({
        "workload": args.workload, "device": torch.cuda.get_device_name(0),
        "power_limit": harness.power_limit(), "updates_each": len(seconds["on"]),
        "median_s": med, "seconds": seconds,
        "on_over_off_pct": 100 * (med["on"] / med["off"] - 1),
        "record_over_off_pct": 100 * (med["record"] / med["off"] - 1),
        "spans_per_update": spans, "syncs_per_update": syncs, "bookkeeping": book,
        "record": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

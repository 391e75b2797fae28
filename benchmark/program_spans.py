"""The program's own spans and counters (`splendax_torch.trace`), as the
per-layer metrics of `benchmark/metrics/` read them after a traced run.

The program keeps one record per update or eval (the root), in the order
they ran.  The window's operations are those after the warm-up's and before
the profiled operation's: records [1 : 1 + ops].  A program without the
trace module, or without such records, gives None.
"""

from __future__ import annotations


def window(rec: dict, root: str) -> list | None:
    """The records of the window's operations, or None."""
    try:
        from splendax_torch import trace
    except ImportError:
        return None
    recs = trace.records(root)[1 : 1 + rec["ops"]]
    return recs or None


def host_ms(recs: list, paths: tuple) -> float:
    """The host's own milliseconds per operation in the spans at `paths`:
    their total time less the time `trace.sync` blocked inside them."""
    ns = sum(r["spans"][p]["total_ns"] - r["spans"][p]["blocked_ns"]
             for r in recs for p in paths if p in r["spans"])
    return ns / len(recs) / 1e6


def syncs(recs: list) -> float:
    """Blocking reads (`sync.<site>` counters) per operation."""
    return sum(v for r in recs for k, v in r["counters"].items()
               if k.startswith("sync.")) / len(recs)

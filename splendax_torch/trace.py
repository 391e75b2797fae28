"""Spans and counters inside the port: where the host spends an update or an
eval, and where it waits on the device.

    from splendax_torch import trace

    with trace.span("rollout"):              # a named span, nested by the call tree
        ...
    trace.count("kernel_a.launches")         # a counter
    n = trace.sync("pool.counts", t.tolist)  # a blocking device-to-host read

A span opened while no span is open and named in `ROOTS` ("update", one
`train/ppo.update_step`; "eval", one `eval/suite.eval_vs_opponent` or
`head_to_head`) is a root: when it closes, the process keeps one record of
it (`records(root)`, the newest `MAX_RECORDS` a root) that holds
  * `start_ns`, `end_ns`: the root's ends on `time.time_ns()`;
  * `spans`: for each path of spans under the root (`update/rollout/engine.ply`)
    its `count`, `total_ns`, `self_ns` (total less its child spans) and
    `blocked_ns` (the time `sync` waited while it was open);
  * `counters`: each counter's change during the operation.
These aggregates are always on.  A span costs two clock reads and a dict
update; it reads no tensor, synchronises nothing and allocates no tensor.
Spans opened outside any root nest and record as usual but keep no
aggregate.

Every blocking read on the update and eval paths goes through `sync`, which
counts `sync.<site>` and adds the time it blocked to `sync_ns.<site>` and to
every open span's blocked time.  A span's total less its blocked time is
the host's own time issuing its work.

`recording()` also keeps a record of each span and each sync while open:
name, path, its id and its parent span's id, start and end on
`time.time_ns()`, the clock torch.profiler stamps its events with, so
`chrome_events(base_ns, spans)` lines them up with the profiler's Chrome
trace (`train.py --profile-updates` writes both into one file).

The state is the process's, kept for the thread that runs the updates and
evals (the port runs them on one thread).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

ROOTS = ("update", "eval")
MAX_RECORDS = 4096

_clock = time.time_ns  # the profiler's clock
_counters: dict = {}
_stack: list = []  # the open spans, innermost last
_agg = None  # the open root's {path: [count, total, self, blocked]}
_counters0: dict = {}  # the counters as the open root found them
_records = {r: collections.deque(maxlen=MAX_RECORDS) for r in ROOTS}
_recorded = None  # the span records while `recording()` is open
_ids = itertools.count(1)


class span:
    """A named span (a context manager); a root when named in `ROOTS` and
    opened outside every span."""

    __slots__ = ("name", "path", "id", "parent", "start", "child", "blocked", "root")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _agg, _counters0
        parent = _stack[-1] if _stack else None
        if parent is None:
            self.path = self.name
            self.root = self.name in ROOTS
            if self.root:
                _agg, _counters0 = {}, dict(_counters)
        else:
            self.path = parent.path + "/" + self.name
            self.root = False
        self.parent = parent
        self.id = next(_ids)
        self.child = self.blocked = 0
        _stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        global _agg
        end = _clock()
        _stack.pop()
        total = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child += total
        if _agg is not None:
            a = _agg.get(self.path)
            if a is None:
                _agg[self.path] = [1, total, total - self.child, self.blocked]
            else:
                a[0] += 1
                a[1] += total
                a[2] += total - self.child
                a[3] += self.blocked
        if _recorded is not None:
            _recorded.append({"name": self.name, "path": self.path, "id": self.id,
                              "parent": parent.id if parent is not None else None,
                              "start_ns": self.start, "end_ns": end,
                              "blocked_ns": self.blocked})
        if self.root:
            _records[self.name].append({
                "root": self.name, "start_ns": self.start, "end_ns": end,
                "spans": {p: {"count": a[0], "total_ns": a[1], "self_ns": a[2],
                              "blocked_ns": a[3]} for p, a in _agg.items()},
                "counters": {k: v - _counters0.get(k, 0) for k, v in _counters.items()
                             if v != _counters0.get(k, 0)}})
            _agg = None
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """Counter `name`'s total in this process."""
    return _counters.get(name, 0)


def counters(prefix: str) -> dict:
    """Every counter whose name starts with `prefix`: {name: total}."""
    return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def zero(prefix: str) -> None:
    """Set every counter whose name starts with `prefix` to 0."""
    for k in _counters:
        if k.startswith(prefix):
            _counters[k] = 0


def sync(site: str, fn):
    """`fn()`, a read that blocks on the device, counted at `site`: returns
    its value, adds 1 to `sync.<site>` and the time it blocked to
    `sync_ns.<site>` and to every open span's blocked time."""
    start = _clock()
    value = fn()
    end = _clock()
    blocked = end - start
    count("sync." + site)
    count("sync_ns." + site, blocked)
    for s in _stack:
        s.blocked += blocked
    if _recorded is not None:
        parent = _stack[-1] if _stack else None
        _recorded.append({"name": "sync." + site,
                          "path": (parent.path + "/" if parent else "") + "sync." + site,
                          "id": next(_ids), "parent": parent.id if parent else None,
                          "start_ns": start, "end_ns": end, "blocked_ns": blocked})
    return value


def records(root: str) -> list:
    """The kept records of root `root`, oldest first."""
    return list(_records[root])


@contextlib.contextmanager
def recording():
    """Keep a record of each span and sync that closes while open; yields
    the list they go into."""
    global _recorded
    outer, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = outer


def chrome_events(base_ns: int, spans: list) -> list:
    """The records `recording()` kept, as Chrome-trace complete ("X")
    events, `ts = (start_ns - base_ns) / 1000` in us as torch.profiler's
    `export_chrome_trace` writes them, on this process and thread."""
    pid, tid = os.getpid(), threading.get_native_id()
    return [{"ph": "X", "cat": "splendax_torch", "name": r["name"], "pid": pid, "tid": tid,
             "ts": (r["start_ns"] - base_ns) / 1000, "dur": (r["end_ns"] - r["start_ns"]) / 1000,
             "args": {"path": r["path"], "id": r["id"], "parent": r["parent"],
                      "blocked_us": r["blocked_ns"] / 1000}}
            for r in spans]


def reset() -> None:
    """Forget the kept records (the counters keep their totals)."""
    for d in _records.values():
        d.clear()

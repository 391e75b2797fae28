"""The readers of the program's own spans and counters
(`benchmark/program_spans.py`, `benchmark/metrics/*_host_ms.*`,
`host_syncs_per_update.update`): on synthetic records, with the warm-up's and
the profiled operation's left out; None without records or without the
program's trace module; and a traced run on the CPU of an update cell and of
the eval cell that reports them."""

from __future__ import annotations

import math
import sys

import pytest
import torch

from benchmark import harness
from benchmark import run as bench_run
from splendax_torch import trace

NEW = {"host_syncs_per_update.update": "update", "engine_host_ms.update": "update",
       "opponent_host_ms.update": "update", "search_host_ms.eval": "eval"}


def record(root: str, k: int) -> dict:
    """A root record whose every number grows with k (ms = 1e6 ns)."""
    span = {"count": 1, "total_ns": 10e6 * k, "self_ns": 0, "blocked_ns": 1e6 * k}
    paths = (["update/rollout/engine.ply", "update/rollout/engine.reset", "update/rollout/pool",
              "update/rollout/search"] if root == "update" else ["eval/eval.turn/search"])
    return {"root": root, "start_ns": 0, "end_ns": 1, "spans": {p: dict(span) for p in paths},
            "counters": {"sync.pool.counts": k, "sync.ppo.kl": 2 * k, "sync_ns.ppo.kl": 99 * k,
                         "kernel_a.launches": 7}}


@pytest.fixture
def records(monkeypatch):
    """The program's records: the warm-up (k=1000), two window operations
    (k=1, 3), the profiled one (k=1000)."""
    kept = {root: [record(root, k) for k in (1000, 1, 3, 1000)] for root in trace.ROOTS}
    monkeypatch.setattr(trace, "records", lambda root: list(kept[root]))
    return kept


def test_readers_read_the_window_only(records):
    upd, ev = {"kind": "update", "ops": 2}, {"kind": "eval", "ops": 2}
    read = {name: harness.reader(name) for name in NEW}
    assert read["host_syncs_per_update.update"](upd) == (3 + 9) / 2
    assert read["engine_host_ms.update"](upd) == 2 * (9 + 27) / 2
    assert read["opponent_host_ms.update"](upd) == 2 * (9 + 27) / 2
    assert read["search_host_ms.eval"](ev) == (9 + 27) / 2
    for name, kind in NEW.items():
        other = {"kind": "eval" if kind == "update" else "update", "ops": 2}
        assert read[name](other) is None


def test_readers_give_none_without_records(monkeypatch):
    monkeypatch.setattr(trace, "records", lambda root: [])
    for name, kind in NEW.items():
        assert harness.reader(name)({"kind": kind, "ops": 3}) is None
    # Only the warm-up's record: no window operation.
    monkeypatch.setattr(trace, "records", lambda root: [record(root, 1)])
    for name, kind in NEW.items():
        assert harness.reader(name)({"kind": kind, "ops": 3}) is None


def test_readers_give_none_without_the_trace_module(monkeypatch):
    """A program that predates the trace module (the parent's)."""
    monkeypatch.setitem(sys.modules, "splendax_torch.trace", None)
    for name, kind in NEW.items():
        assert harness.reader(name)({"kind": kind, "ops": 3}) is None


@pytest.mark.parametrize("cell,small", [
    ("ac_h768.league_static", {"num_envs": 256, "num_steps": 8, "minibatch_size": 512,
                               "total_timesteps": 3814 * 2048, "checked": 1}),
    ("ac_h768.eval_gumbel", {"games": 4, "checked": [0]}),
])
def test_a_traced_cpu_run_reports_the_program_metrics(cell, small):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        trace.reset()
        c = harness.load_cell(cell)
        result, _ = bench_run.measure(c, 11, 0.01, True, device="cpu", small=small)
    finally:
        torch.set_num_threads(n)
    want = {name for name, kind in NEW.items() if kind == ("eval" if "eval" in cell else "update")}
    got = result["metrics"]
    assert want <= set(got) and not (set(NEW) - want) & set(got)
    for name in want:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] > 0, (name, got[name])
    if "league" in cell:
        # Each turn: a pool count, the blank state's and the ring's copies.
        assert got["host_syncs_per_update.update"]["value"] >= 3 * small["num_steps"] + 1

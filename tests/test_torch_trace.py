"""`splendax_torch.trace`: spans, counters and syncs, the per-operation records
of the update and the eval, recording on the profiler's clock, and the
launch counters of kernels A and B read from its registry.  CPU only, a few
seconds."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from splendax_torch import trace
from splendax_torch.eval import suite
from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.ops import ring_take as rt
from splendax_torch.search import gumbel
from splendax_torch.train import ppo
from splendax_torch.train.config import PPOConfig

UPDATE_PATHS = {
    "update", "update/rollout", "update/rollout/agent", "update/rollout/pool",
    "update/rollout/engine.ply", "update/rollout/engine.ply/engine.token_return",
    "update/rollout/engine.reset", "update/gae", "update/epochs", "update/epochs/epochs.step",
    "update/pool.push"}
SEARCH_PATHS = {
    "update/rollout/search", "update/rollout/search/search.round",
    "update/rollout/search/search.round/engine.token_return"}
SLOTS = {"none": dict(), "static": dict(search_opponent=True, search_static=True),
         "bernoulli": dict(search_opponent=True, p_search=0.5)}


@pytest.fixture
def clock(monkeypatch):
    """A fake clock: `clock[0]` is the time in ns."""
    now = [0]
    monkeypatch.setattr(trace, "_clock", lambda: now[0])
    trace.reset()
    yield now
    trace.reset()


def tiny_cfg(slot: str, **kw) -> PPOConfig:
    return PPOConfig(num_envs=16, num_steps=4, hidden=16, pool_size=3, minibatch_size=32,
                     update_epochs=2, snapshot_every_updates=1, total_timesteps=16 * 4 * 8,
                     search_m=4, search_k0=2, search_horizon=2, seed=3, **SLOTS[slot], **kw)


def test_nesting_self_and_blocked_time_under_a_fake_clock(clock):
    def block(ns):
        def fn():
            clock[0] += ns
            return "read"
        return fn

    with trace.span("update"):
        clock[0] = 10
        with trace.span("rollout"):
            clock[0] = 15
            with trace.span("engine.ply"):
                clock[0] = 20
                assert trace.sync("site", block(5)) == "read"
                clock[0] = 30
            with trace.span("engine.ply"):
                clock[0] = 40
            clock[0] = 50
        trace.count("things", 3)
        assert trace.sync("site", block(2)) == "read"
        clock[0] = 60
    (rec,) = trace.records("update")
    assert (rec["root"], rec["start_ns"], rec["end_ns"]) == ("update", 0, 60)
    assert rec["spans"] == {
        "update/rollout/engine.ply": {"count": 2, "total_ns": 25, "self_ns": 25, "blocked_ns": 5},
        "update/rollout": {"count": 1, "total_ns": 40, "self_ns": 15, "blocked_ns": 5},
        "update": {"count": 1, "total_ns": 60, "self_ns": 20, "blocked_ns": 7}}
    assert rec["counters"] == {"things": 3, "sync.site": 2, "sync_ns.site": 7}
    # Outside a root a span nests but keeps no record.
    with trace.span("rollout"), trace.span("engine.ply"):
        clock[0] = 70
    assert len(trace.records("update")) == 1 and trace.records("eval") == []


def test_records_are_bounded(clock):
    for i in range(trace.MAX_RECORDS + 3):
        clock[0] = 10 * i
        with trace.span("eval"):
            clock[0] += 1
    recs = trace.records("eval")
    assert len(recs) == trace.MAX_RECORDS
    assert recs[0]["start_ns"] == 30 and recs[-1]["start_ns"] == 10 * (trace.MAX_RECORDS + 2)


def test_recording_is_on_the_profilers_clock():
    """A span brackets the profiler's event inside it; the Chrome events put
    it at the same offset from the trace's base as the profiler writes."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.recording() as recs:
        with trace.span("outer"):
            with record_function("inner"):
                torch.ones(8).add_(1)
            trace.sync("site", lambda: None)
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    outer = next(r for r in recs if r["name"] == "outer")
    assert outer["start_ns"] <= ev.start_ns() <= ev.end_ns() <= outer["end_ns"]
    sync = next(r for r in recs if r["name"] == "sync.site")
    assert sync["parent"] == outer["id"] and sync["path"] == "outer/sync.site"
    base = ev.start_ns() - 5000
    (x,) = [e for e in trace.chrome_events(base, recs) if e["name"] == "outer"]
    assert x["ph"] == "X" and x["ts"] == (outer["start_ns"] - base) / 1000
    assert x["dur"] == (outer["end_ns"] - outer["start_ns"]) / 1000
    assert x["args"]["path"] == "outer"


def _bits(ts, metrics) -> dict:
    st = ts.opt_state
    out = {f"p{i}": p.detach() for i, p in enumerate(ts.params.parameters())}
    out.update({f"mu{i}": m for i, m in enumerate(st.mu)})
    out.update({f"nu{i}": v for i, v in enumerate(st.nu)})
    out.update({f"m_{k}": v for k, v in metrics.items()})
    out["count"] = torch.as_tensor(st.count)
    return out


def test_recording_changes_no_number_of_an_update():
    """A tiny league update with recording on and off: the same bits in the
    parameters, both Adam moments, the step count and the metrics."""
    cfg = tiny_cfg("static")
    runs = []
    for record in (False, True):
        torch.manual_seed(0)
        ts = ppo.init_train_state(cfg, device="cpu")
        if record:
            with trace.recording() as recs:
                ts, metrics = ppo.update_step(cfg, ts)
            assert any(r["name"] == "update" for r in recs)
        else:
            ts, metrics = ppo.update_step(cfg, ts)
        runs.append(_bits(ts, metrics))
    assert runs[0].keys() == runs[1].keys()
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.parametrize("slot", list(SLOTS))
def test_an_update_record_counts_its_syncs_and_has_every_span(slot):
    """The record of one update: a pool count a turn, a KL read an optimizer
    step taken, the Bernoulli slot's row read a turn, the blank state's and
    the ring's copies a turn; every span path of the update."""
    cfg = tiny_cfg(slot)
    ts = ppo.init_train_state(cfg, device="cpu")
    trace.reset()
    steps0 = ts.opt_state.count
    ts, _ = ppo.update_step(cfg, ts)
    (rec,) = trace.records("update")
    c, T = rec["counters"], cfg.num_steps
    assert c["sync.pool.counts"] == T
    assert c["sync.ppo.kl"] == ts.opt_state.count - steps0 > 0
    assert c.get("sync.ppo.league_rows", 0) == (T if slot == "bernoulli" else 0)
    assert c["sync.ring.deck_count"] == T
    assert c["sync.state.blank"] == T + 1  # and the ring's deal
    assert c["sync.ppo.scalars"] == 1
    paths = set(rec["spans"])
    assert paths >= UPDATE_PATHS
    assert (paths >= SEARCH_PATHS) == (slot != "none")
    spans = rec["spans"]
    assert spans["update/rollout/engine.ply"]["count"] == 2 * T
    assert spans["update/rollout/engine.reset"]["count"] == T
    assert spans["update/epochs/epochs.step"]["count"] == c["sync.ppo.kl"]
    if slot == "static":
        assert spans["update/rollout/search/search.round"]["count"] == 2 * T  # log2(m)
    for s in spans.values():
        assert 0 <= s["blocked_ns"] <= s["total_ns"] and 0 <= s["self_ns"] <= s["total_ns"]


def test_an_eval_record_counts_its_turns():
    params = ac.ActorCritic(16, torch.Generator().manual_seed(1), "cpu")
    bot = gumbel.gumbel_search_policy(m=4, k0=2, horizon=1,
                                      params=fac.PreparedWeights(ac.kernel_weights(params)))
    trace.reset()
    suite.eval_vs_opponent(bot, suite.model_greedy_policy(params), 4, seed=5, device="cpu")
    (rec,) = trace.records("eval")
    turns = rec["spans"]["eval/eval.turn"]["count"]
    assert turns > 0 and rec["counters"]["sync.eval.active"] == turns
    assert rec["counters"]["sync.eval.result"] == 1
    assert rec["spans"]["eval/eval.turn/search"]["count"] == turns
    assert {"eval/eval.turn/engine.ply", "eval/eval.turn/search/search.round"} <= set(rec["spans"])


def test_launch_counters_read_from_the_registry():
    """kernel A's and kernel B's counters keep their names, keys and order,
    read what the registry counts, and zero through the bench."""
    from splendax_torch import bench

    assert list(fac.launch_counts()) == [
        "fused_actor_critic", "fused_actor_critic_wgmma", "fused_actor_critic_wide",
        "fused_actor_critic_tile", "fused_actor_critic_cluster",
        "fused_actor_critic_wide_pass", "fused_actor_critic_wide_half", "fused_actor_critic_prep",
        "fused_actor_critic_critic_only"]
    assert list(fac.launches_by_route) == ["wgmma", "wide"]
    assert list(fac.launches_by_mode) == ["tile", "cluster"]
    assert list(fac.launches_by_wide_mode) == ["pass", "half"]
    before = (fac.launch_counts(), rt.launches)
    for name in ("kernel_a.launches", "kernel_a.route.wide", "kernel_a.wide_mode.half",
                 "kernel_a.prep", "kernel_a.heads.critic", "kernel_b.launches"):
        trace.count(name)
    n = fac.launch_counts()
    assert {k: n[k] - before[0][k] for k in n if n[k] != before[0][k]} == {
        "fused_actor_critic": 1, "fused_actor_critic_wide": 1, "fused_actor_critic_wide_half": 1,
        "fused_actor_critic_prep": 1, "fused_actor_critic_critic_only": 1}
    assert rt.launches == before[1] + 1
    assert (fac.launches, fac.prep_launches, fac.critic_launches) == (
        n["fused_actor_critic"], n["fused_actor_critic_prep"], n["fused_actor_critic_critic_only"])
    bench.zero_launches()
    assert set(bench.kernel_launches().values()) == {0}
    trace.count("kernel_b.launches")
    assert rt.launches == 1
    with pytest.raises(AttributeError):
        fac.no_such_counter
    # A CPU forward launches nothing.
    cfg = tiny_cfg("none")
    ts = ppo.init_train_state(cfg, device="cpu")
    before = bench.kernel_launches()
    ppo.rollout(dataclasses.replace(cfg, num_steps=1), ts)
    assert bench.kernel_launches() == before

"""A run with the timed path broken underneath comes out not correct, and
the control (the reference in TF32 put in the program's place) fails too.

Each test skips the harness's look for a card and drives the rest of a run
(`run.measure` on the CPU at a tiny size, the program's plain versions in
place of its kernels) against the cell's limits.  The faults are those a
cell can have: a step that leaves the state unchanged, half of each
minibatch left out with the mean over the rest, an answer altered where it
is made (the engine's reward, a pool slot's move, the league slot's or the
eval bot's search, kernel A's value).  Three more show only from the second
update on, so only the followed window update can catch them: kernel A's
prepared weights never prepared again, Adam's moments reset between
updates, the snapshot push left out.  No cell spans chips, so none can
leave out an exchange between them.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark import run as bench_run

# 2,048 rows in minibatches of 512: the first step's loss averages enough rows
# to sit under its limit (at 64 rows it reads 5.5e-6 on the CPU).  The check
# follows the warm-up and the window's second update (3,408, after the push).
UPDATE = {"num_envs": 256, "num_steps": 8, "minibatch_size": 512,
          "total_timesteps": 3814 * 2048, "checked": 1}
EVAL = {"games": 4, "checked": [0]}


def correct_of(cell_name: str, small: dict, seed: int = 7, seconds: float = 0.01):
    cell = harness.load_cell(cell_name)
    result, numbers = bench_run.measure(cell, seed, seconds, False, device="cpu", small=small)
    correct, checks = bench_run.verdict(numbers, cell["limits"], result["failed"])
    return correct, checks


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["ac_h768.league_static", "ac_h768.league_noslot",
                                  "ac_h1024.league_noslot"])
def test_a_sound_update_run_is_correct(cell):
    correct, checks = correct_of(cell, UPDATE)
    assert correct, checks


def test_a_sound_eval_run_is_correct():
    correct, checks = correct_of("ac_h768.eval_gumbel", EVAL)
    assert correct, checks
    assert checks["search_miss"]["value"] == 0.0


def _unchanged(monkeypatch):
    from splendax_torch.train import optim

    monkeypatch.setattr(optim, "step", lambda params, grads, state, lr, **kw: state)
    return ("grad_gap", "delta_gap")


def _half_batch(monkeypatch):
    from splendax_torch.train import ppo

    loss = ppo.ppo_loss

    def half(cfg, ent, params, *rows, denom=None):
        return loss(cfg, ent, params, *(x[: x.shape[0] // 2] for x in rows), denom=denom)

    monkeypatch.setattr(ppo, "ppo_loss", half)
    return ("loss_gap", "grad_gap")


def _reward_altered(monkeypatch):
    from splendax_torch.selfplay import dual

    step = dual.dual_step_autoreset_ring

    def altered(*args, **kw):
        carry, out, obs, mask, done, ring = step(*args, **kw)
        out.agent_reward = out.agent_reward.clone()
        out.agent_reward[0] += 0.5
        return carry, out, obs, mask, done, ring

    monkeypatch.setattr(dual, "dual_step_autoreset_ring", altered)
    return ("engine",)


def _next_legal(action, mask):
    n = mask.shape[1]
    dist = (torch.arange(n)[None] - action[:, None] - 1) % n
    return torch.argmin(torch.where(mask, dist, n), 1)


def _pool_altered(monkeypatch):
    from splendax_torch.selfplay import pool

    greedy = pool.pool_greedy_policy

    def altered(p, opp_idx):
        policy = greedy(p, opp_idx)
        return lambda obs, mask, state: _next_legal(policy(obs, mask, state), mask)

    monkeypatch.setattr(pool, "pool_greedy_policy", altered)
    return ("opp_gap",)


def _search_altered(monkeypatch):
    from splendax_torch.train import ppo

    make = ppo.gumbel_search_fn

    def altered(**kw):
        fn = make(**kw)

        def search(ctx, obs, mask, state, generator=None, draws=None):
            return _next_legal(fn(ctx, obs, mask, state, generator, draws=draws), mask)
        return search

    monkeypatch.setattr(ppo, "gumbel_search_fn", altered)
    return ("search_miss",)


def _value_altered(monkeypatch):
    from splendax_torch.train import ppo

    fwd = ppo.fused_masked_forward

    def altered(weights, obs, mask, with_value=True):
        logits, value = fwd(weights, obs, mask, with_value)
        return logits, None if value is None else value + 1e-2

    monkeypatch.setattr(ppo, "fused_masked_forward", altered)
    return ("fwd_err",)


def _stale_prep(monkeypatch):
    """Each PreparedWeights handle's forwards run the weights of its first
    preparation, as if a write never made it stale (on the CPU the forward
    reads the weights themselves, so the handle's first weights are kept)."""
    from splendax_torch.ops.fused_actor_critic import PreparedWeights
    from splendax_torch.selfplay import pool
    from splendax_torch.train import ppo

    first = {}

    def stale(fwd):
        def forward(weights, obs, mask, with_value=True):
            if isinstance(weights, PreparedWeights):
                key = id(weights)
                if key not in first:
                    first[key] = (weights, [w.clone() for w in weights])
                weights = first[key][1]
            return fwd(weights, obs, mask, with_value)
        return forward

    monkeypatch.setattr(ppo, "fused_masked_forward", stale(ppo.fused_masked_forward))
    monkeypatch.setattr(pool, "fused_masked_forward", stale(pool.fused_masked_forward))
    return ("fwd_err",)


def _adam_reset(monkeypatch):
    from splendax_torch.train import optim, ppo

    epochs = ppo._ppo_epochs

    def reset(cfg, ts, *args, **kw):
        ts.opt_state = optim.init(ts.params.parameters())
        return epochs(cfg, ts, *args, **kw)

    monkeypatch.setattr(ppo, "_ppo_epochs", reset)
    return ("grad_gap", "delta_gap")


def _no_push(monkeypatch):
    from splendax_torch.selfplay import pool

    monkeypatch.setattr(pool, "push_snapshot",
                        lambda p, model: p.replace(n_snapshots=p.n_snapshots + 1))
    return ("opp_gap",)


@pytest.mark.parametrize("plant", [_unchanged, _half_batch, _reward_altered, _pool_altered,
                                   _search_altered, _value_altered, _stale_prep, _adam_reset,
                                   _no_push])
def test_an_update_with_a_planted_fault_is_not_correct(plant, monkeypatch):
    numbers = plant(monkeypatch)
    correct, checks = correct_of("ac_h768.league_static", UPDATE)
    assert not correct
    assert any(checks[n]["value"] > checks[n]["limit"] for n in numbers), checks


def _eval_search_altered(monkeypatch):
    from splendax_torch.search import gumbel

    policy = gumbel.gumbel_search_policy

    def altered(**kw):
        fn, ctx = policy(**kw)

        def search(ctx, obs, mask, state, generator=None):
            return _next_legal(fn(ctx, obs, mask, state, generator), mask)
        return search, ctx

    monkeypatch.setattr(gumbel, "gumbel_search_policy", altered)
    return ("search_miss",)


def _eval_opponent_altered(monkeypatch):
    from splendax_torch.eval import suite

    greedy = suite._greedy_model_fn
    monkeypatch.setattr(suite, "_greedy_model_fn", lambda w, obs, mask, state, g: _next_legal(
        greedy(w, obs, mask, state, g), mask))
    return ("opp_gap",)


def _eval_engine_altered(monkeypatch):
    from splendax_torch.selfplay import dual

    step = dual.dual_step

    def altered(*args, **kw):
        nxt, out = step(*args, **kw)
        nxt.prestige = nxt.prestige.clone()
        nxt.prestige[0, 0] += 1
        return nxt, out

    monkeypatch.setattr(dual, "dual_step", altered)
    return ("engine",)


@pytest.mark.parametrize("plant", [_eval_search_altered, _eval_opponent_altered,
                                   _eval_engine_altered])
def test_an_eval_with_a_planted_fault_is_not_correct(plant, monkeypatch):
    numbers = plant(monkeypatch)
    correct, checks = correct_of("ac_h768.eval_gumbel", EVAL)
    assert not correct
    assert any(checks[n]["value"] > checks[n]["limit"] for n in numbers), checks


def test_the_eval_driver_refuses_a_bot_it_cannot_run():
    """Another search or opponent needs a driver and a reference of its own:
    the eval driver and the reference refuse it rather than time Gumbel."""
    from benchmark.reference import follow

    c = harness.load_cell("ac_h768.eval_gumbel")
    for traffic in (dict(c["traffic"], bot=dict(c["traffic"]["bot"], algo="mc")),
                    dict(c["traffic"], opponent="random")):
        with pytest.raises(ValueError):
            harness.driver("eval").Run(dict(c, traffic=traffic), 7, "cpu", EVAL)
    with pytest.raises(ValueError):
        follow.check_eval({"bot": dict(c["traffic"]["bot"], algo="uct"), "agent": "",
                           "evals": []}, "cpu")


@pytest.mark.parametrize("cell", ["ac_h768.league_static", "ac_h768.eval_gumbel"])
def test_the_control_is_not_correct(cell):
    """The reference in float32 with TF32 products in the program's place
    (on the CPU the TF32 rounding is emulated) fails the cell's limits."""
    c = harness.load_cell(cell)
    run = harness.driver(c["traffic"]["kind"]).Run(c, 7, "cpu",
                                                   UPDATE if "league" in cell else EVAL)
    run.warm()
    run.finish()
    run.release()
    out = run.check(controls=("tf32",))
    assert bench_run.verdict(out["program"], c["limits"], 0)[0], out["program"]
    assert not bench_run.verdict(out["tf32"], c["limits"], 0)[0], out["tf32"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ac_h768.league_static", "ac_h1024.league_noslot",
                                  "ac_h768.eval_gumbel"])
def test_the_control_is_not_correct_on_the_card(cell):
    """The same on the card, where the control's products run with cuBLAS's
    TF32 switched on, at the tiny size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = harness.load_cell(cell)
    run = harness.driver(c["traffic"]["kind"]).Run(c, 7, "cuda",
                                                   UPDATE if "league" in cell else EVAL)
    run.build_kernels()
    run.warm()
    run.finish()
    run.release()
    out = run.check(controls=("tf32",))
    assert bench_run.verdict(out["program"], c["limits"], 0)[0], out["program"]
    assert not bench_run.verdict(out["tf32"], c["limits"], 0)[0], out["tf32"]

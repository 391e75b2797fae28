"""The search-hardened league slot of the port's trainer
(`splendax_torch.train.ppo`) against the JAX package: the sentinel sampling,
the routing of the opponents' move, one whole turn of the static league in
lockstep on the same params, pool, ring and draws, and whole `update_step`s
with each kind of slot on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.engine.types import GameState as JGameState
from splendax.env import ring as jring
from splendax.models import actor_critic as jac
from splendax.selfplay import dual as jdual
from splendax.selfplay import pool as jpool_lib
from splendax.train import ppo as jppo
from splendax.train.config import PPOConfig as JPPOConfig
from splendax_torch.engine import rules, state as S
from splendax_torch.engine.encode import encode_observation
from splendax_torch.env import core, ring
from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.selfplay import pool as pool_lib
from splendax_torch.train import ppo, train
from splendax_torch.train.config import PPOConfig
from test_torch_rollout import H, P, both_pools, jax_params
from test_torch_search import gumbel_draws, near_tie_rows

SLOT = dict(search_opponent=True, search_m=4, search_k0=2, search_horizon=2)


def tiny_cfg(**kw):
    base = dict(num_envs=16, num_steps=8, hidden=H, pool_size=P, minibatch_size=32,
                update_epochs=2, total_timesteps=16 * 8 * 6, seed=1, **SLOT)
    base.update(kw)
    return PPOConfig(**base)


@pytest.mark.parametrize("n,p_search", [(16, 0.25), (32, 0.125), (4, 0.125), (24, 0.3), (8, 1.0)])
def test_static_sentinel_rows_match_jax(n, p_search):
    """Exact: the static partition's rows, their number and their stride."""
    kw = dict(num_envs=n, p_search=p_search, search_opponent=True, search_static=True)
    cfg, jcfg = PPOConfig(**kw), JPPOConfig(**kw)
    assert (cfg.n_search_static, cfg.search_stride) == (jcfg.n_search_static, jcfg.search_stride)
    got = ppo._static_sentinel_rows(cfg, n, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jppo._static_sentinel_rows(jcfg, n)))
    assert int(got.sum()) == cfg.n_search_static >= 1


def test_sample_opponents_static_matches_jax():
    """The static partition pins the same rows to the sentinel `pool_size +
    1` as JAX's; every other row draws a real slot."""
    rng = np.random.RandomState(0)
    _, jp, pp = both_pools(rng)
    kw = dict(num_envs=32, p_search=0.25, pool_size=P, search_static=True, **SLOT)
    want = np.asarray(jppo._sample_opponents(JPPOConfig(**kw), jp, jax.random.PRNGKey(3), (32,)))
    got = ppo._sample_opponents(PPOConfig(**kw), pp, torch.Generator().manual_seed(3), 32).numpy()
    np.testing.assert_array_equal(got == P + 1, want == P + 1)
    assert (got == P + 1).sum() == 8 and (got[got != P + 1] <= P).all()
    assert set(got[got != P + 1]) == {0, 1, P}  # two frozen snapshots and CURRENT
    assert got.dtype == np.int64


def test_sample_opponents_bernoulli():
    """The sentinel is drawn with probability p_search (0.5 +- 0.03 over
    4096 draws); without the slot it never appears."""
    _, _, pp = both_pools(np.random.RandomState(0))
    g = torch.Generator().manual_seed(1)
    idx = ppo._sample_opponents(tiny_cfg(p_search=0.5), pp, g, 4096)
    assert abs((idx == P + 1).float().mean().item() - 0.5) < 0.03 and int(idx.max()) == P + 1
    assert int(ppo._sample_opponents(tiny_cfg(search_opponent=False), pp, g, 4096).max()) <= P


def test_pool_greedy_policy_leaves_sentinel_rows_to_the_search():
    """Sentinel rows launch no forward and take the first legal action, as
    the all-zero logits of JAX's unmatched one-hot give; the other rows are
    JAX's greedy actions exactly."""
    rng = np.random.RandomState(2)
    _, jp, pp = both_pools(rng)
    st, obs, mask = core.reset(24, torch.Generator().manual_seed(2), "cpu")
    idx = rng.randint(0, P + 2, 24)
    idx[:3] = P + 1
    want = jpool_lib.pool_greedy_policy(jp, jnp.asarray(idx, jnp.int32))(
        jnp.asarray(obs.numpy()), jnp.asarray(mask.numpy()), None, None)
    got = pool_lib.pool_greedy_policy(pp, torch.from_numpy(idx))(obs, mask, st)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sent = torch.from_numpy(idx == P + 1)
    assert torch.equal(got[sent], torch.argmax(mask[sent].int(), -1))
    all_sent = pool_lib.pool_greedy_policy(pp, torch.full((24,), P + 1))(obs, mask, st)
    assert torch.equal(all_sent, torch.argmax(mask.int(), -1))


def test_record_outcomes_ignores_the_sentinel():
    """Exact against JAX: episodes of the sentinel slot add nothing to the
    PFSP counts."""
    rng = np.random.RandomState(3)
    _, jp, pp = both_pools(rng)
    idx = rng.randint(0, P + 2, 300)
    done, won = rng.rand(300) < 0.6, rng.rand(300) < 0.5
    jp = jpool_lib.record_outcomes(jp, jnp.asarray(idx), jnp.asarray(done), jnp.asarray(won))
    pp = pool_lib.record_outcomes(pp, torch.from_numpy(idx), torch.from_numpy(done),
                                  torch.from_numpy(won))
    np.testing.assert_array_equal(pp.games.numpy(), np.asarray(jp.games))
    np.testing.assert_array_equal(pp.wins.numpy(), np.asarray(jp.wins))
    assert (idx == P + 1).sum() > 0
    assert pp.games.sum().item() == (done & (idx <= P)).sum()
    only = pool_lib.record_outcomes(pp, torch.full((50,), P + 1), torch.ones(50, dtype=torch.bool),
                                    torch.ones(50, dtype=torch.bool))
    assert torch.equal(only.games, pp.games) and torch.equal(only.wins, pp.wins)


@pytest.mark.parametrize("static", [False, True])
def test_search_opponent_routing(static):
    """Rows off the sentinel get exactly the base pool policy's action; the
    search moves the sentinel rows only, and every action is legal.  The
    Bernoulli slot runs the search on the sentinel rows alone."""
    cfg = tiny_cfg(search_static=static, p_search=0.25)
    _, _, pp = both_pools(np.random.RandomState(4))
    st, obs, mask = core.reset(16, torch.Generator().manual_seed(5), "cpu")
    if static:
        idx = ppo._sample_opponents(cfg, pp, torch.Generator().manual_seed(3), 16)
        assert torch.equal(torch.nonzero(idx == P + 1)[:, 0], torch.arange(0, 16, 4))
    else:
        idx = torch.tensor([P + 1 if i % 2 else i % (P + 1) for i in range(16)])
    seen = []
    made = ppo.gumbel_search_fn

    def spy(**kw):
        fn = made(**kw)
        assert kw["greedy_final"] and kw["determinize_fn"] is None and kw["m"] == 4

        def wrapped(ctx, obs, mask, state, generator, draws=None):
            seen.append(obs.shape[0])
            assert all(torch.equal(a, b) for a, b in zip(ctx, pp.slot(P)))  # CURRENT
            return fn(ctx, obs, mask, state, generator, draws=draws)
        return wrapped

    ppo.gumbel_search_fn = spy
    try:
        a = ppo._opponent_policy(cfg, pp, idx, torch.Generator().manual_seed(6))(obs, mask, st)
    finally:
        ppo.gumbel_search_fn = made
    b = pool_lib.pool_greedy_policy(pp, idx)(obs, mask, st)
    sent = idx == P + 1
    assert torch.equal(a[~sent], b[~sent])
    assert mask.gather(1, a[:, None]).all()
    assert seen == [int(sent.sum())]


def test_search_static_sanitizes_resumed_bernoulli_opp_idx():
    """A state whose opp_idx holds the sentinel everywhere (a Bernoulli
    checkpoint resumed under --search-static): after an update the static
    rows hold the sentinel and every other row a real slot, as in JAX."""
    cfg = tiny_cfg(search_static=True, p_search=0.25)
    ts = ppo.init_train_state(cfg, device="cpu")
    ts.opp_idx = torch.full((cfg.num_envs,), cfg.pool_size + 1)
    ts, metrics = ppo.update_step(cfg, ts)
    assert torch.isfinite(metrics["loss"])
    sent = torch.zeros(cfg.num_envs, dtype=torch.bool)
    sent[:: cfg.search_stride] = True
    assert (ts.opp_idx[~sent] <= cfg.pool_size).all() and (ts.opp_idx[sent] == cfg.pool_size + 1).all()
    # The rule itself, against JAX's expression on a random vector.
    idx = np.random.RandomState(5).randint(0, P + 2, cfg.num_envs)
    jcfg = JPPOConfig(num_envs=16, p_search=0.25, search_opponent=True, search_static=True)
    want = jnp.where(jppo._static_sentinel_rows(jcfg, 16), P + 1, jnp.minimum(jnp.asarray(idx), P))
    got = torch.where(ppo._static_sentinel_rows(cfg, 16, "cpu"), P + 1,
                      torch.clamp(torch.from_numpy(idx), max=P))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_search_static_small_config_clamps_to_one_row():
    cfg = tiny_cfg(search_static=True, num_envs=4, p_search=0.125)
    assert cfg.n_search_static == 1
    ts = ppo.init_train_state(cfg, device="cpu")
    assert int(ts.opp_idx[0]) == cfg.pool_size + 1


# ---- one turn of the static league in lockstep -----------------------------------

B, T = 32, 20
LEAGUE = dict(num_envs=B, num_steps=T, hidden=H, pool_size=P, p_search=0.25, search_static=True,
              **SLOT)


@jax.jit
def jax_league_turn(params, jpool, env_state, obs, mask, opp_idx, jr, noise, new_idx, k_step):
    """The body of the JAX package's rollout scan (`train/ppo.py`), with the
    agent's Gumbel noise and the opponent resamples given."""
    logits, value = jac.forward(params, obs)
    ml = jac.masked_logits(logits, mask)
    action = jnp.argmax(ml + noise, axis=-1).astype(jnp.int32)
    policy = jppo._opponent_policy(JPPOConfig(**LEAGUE), jpool, opp_idx)
    env_state, out, obs, mask, done, jr = jdual.dual_step_autoreset_ring(
        env_state, action, policy, k_step, jr, "fast")
    opp_idx = jnp.where(done, new_idx, opp_idx)
    return (env_state, obs, mask, opp_idx, jr,
            dict(action=action, opp_action=out.opp_action, reward=out.agent_reward, done=done))


def test_static_league_turns_match_jax_in_lockstep(monkeypatch):
    """H=32, pool of 3, 32 games of which rows 0, 4, ... face the search
    (m=4 k0=2 horizon 2, greedy_final), 20 turns, the state fed forward from
    JAX each turn.  Exact: agent actions, and on every row whose opponent
    action agrees, all state fields, obs, masks, rewards, done.  Opponent
    actions: exact off the sentinel rows; on them, equal bar near-ties (the
    search's values agree within 1e-5 only), at most 5% set aside."""
    rng = np.random.RandomState(8)
    agent, jp, pp = both_pools(rng)
    cfg = PPOConfig(**LEAGUE)
    S_rows, m, k0, hz = cfg.n_search_static, cfg.search_m, cfg.search_k0, cfg.search_horizon
    assert (S_rows, cfg.search_stride) == (8, 4)
    static = ppo._static_sentinel_rows(cfg, B, "cpu").numpy()
    weights = pp.slot(P)

    infos = []
    made = ppo.gumbel_search_fn

    def with_info(**kw):
        fn = made(**kw)

        def wrapped(*a, **k):
            infos.append({})
            return fn(*a, info=infos[-1], **k)
        return wrapped

    monkeypatch.setattr(ppo, "gumbel_search_fn", with_info)

    st = S.initial_state(B, torch.Generator().manual_seed(8), device="cpu")
    obs, mask = encode_observation(st), rules.legal_mask(st)
    js = JGameState(**{k: jnp.asarray(v) for k, v in S.to_numpy(st).items()})
    jobs, jmask = jnp.asarray(obs.numpy()), jnp.asarray(mask.numpy())
    jr = jring.make_ring(jax.random.PRNGKey(8), 2 * B, window=B)
    pr = ring.FreshGameRing(
        packed=torch.from_numpy(np.array(jr.packed)), mask0=torch.from_numpy(np.array(jr.mask0)),
        ptr=torch.tensor(0), overflow=torch.tensor(0), size=2 * B)

    def slots():
        return np.where(static, P + 1, rng.randint(0, P + 1, B))

    opp_idx = slots()
    jidx, pidx = jnp.asarray(opp_idx, jnp.int32), torch.from_numpy(opp_idx).long()
    params = jax_params(agent)
    aside = differing = episodes = 0
    for turn_no in range(T):
        noise = rng.gumbel(size=(B, 45)).astype(np.float32)
        new_idx = slots()
        k_step = jax.random.fold_in(jax.random.PRNGKey(9), turn_no)
        js, jobs, jmask, jidx, jr, jrec = jax_league_turn(
            params, jp, js, jobs, jmask, jidx, jr, jnp.asarray(noise),
            jnp.asarray(new_idx, jnp.int32), k_step)
        # The search's key in the static slot is fold_in(policy key, 1).
        draws = gumbel_draws(jax.random.fold_in(k_step, 1), S_rows, m, k0, hz, True, False)
        turn = ppo.rollout_turn(cfg, weights, pp, st, obs, mask, pidx, pr,
                                noise=torch.from_numpy(noise),
                                new_idx=torch.from_numpy(new_idx).long(), search_draws=draws)
        msg = f"turn {turn_no}"
        np.testing.assert_array_equal(turn.action.numpy(), np.asarray(jrec["action"]), err_msg=msg)
        same = turn.opp_action.numpy() == np.asarray(jrec["opp_action"])
        assert same[~static].all(), msg
        near = np.zeros(B, bool)
        near[static] = near_tie_rows(infos[-1]).numpy()
        assert (same | near).all(), f"{msg}: a search action differs off a near-tie"
        aside += int(near[static].sum())
        differing += int((~same).sum())
        got = S.to_numpy(turn.env_state)
        for k in S.FIELDS:
            np.testing.assert_array_equal(got[k][same], np.asarray(getattr(js, k))[same],
                                          err_msg=f"{msg} {k}")
        for name, g, w in (("obs", turn.obs, jobs), ("mask", turn.mask, jmask),
                           ("reward", turn.reward, jrec["reward"]), ("done", turn.done, jrec["done"]),
                           ("opp_idx", turn.opp_idx, jidx)):
            np.testing.assert_array_equal(g.numpy()[same], np.asarray(w)[same],
                                          err_msg=f"{msg} {name}")
        assert int(turn.ring.overflow) == int(jr.overflow) == 0, msg
        episodes += int(turn.done.sum())
        # Feed JAX's state forward.
        st = S.from_numpy({k: np.array(getattr(js, k)) for k in S.FIELDS}, "cpu")
        obs, mask = torch.from_numpy(np.array(jobs)), torch.from_numpy(np.array(jmask))
        pidx = torch.from_numpy(np.array(jidx)).long()
        pr = pr.replace(ptr=torch.tensor(int(jr.ptr)))
    print(f"static league lockstep: {aside} of {T * S_rows} searched rows set aside as near-ties, "
          f"{differing} opponent actions differed; {episodes} episodes ended")
    assert len(infos) == T and aside <= 0.05 * T * S_rows
    assert (pidx[torch.from_numpy(static)] == P + 1).all()


# ---- whole updates -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(search_static=True, p_search=0.25),
    dict(p_search=0.5),
    dict(search_static=True, search_censored=True, p_search=0.25),
    dict(p_search=0.5, search_censored=True),
    dict(search_static=True, p_search=0.25, rng_mode="parity"),
], ids=["static", "bernoulli", "static-censored", "bernoulli-censored", "static-parity"])
def test_update_step_with_the_league_slot(kw):
    """A whole update on the CPU with each kind of slot: finite metrics,
    counters advance, sentinel rows present, and the search ran once a turn
    with kernel-layout weights."""
    cfg = tiny_cfg(**kw)
    ts = ppo.init_train_state(cfg, device="cpu")
    sent = cfg.pool_size + 1
    if cfg.search_static:
        k = cfg.search_stride
        assert (ts.opp_idx[: cfg.n_search_static * k : k] == sent).all()
        assert int((ts.opp_idx == sent).sum()) == cfg.n_search_static
    else:
        assert (ts.opp_idx == sent).any() and (ts.opp_idx != sent).any()
    ts, m = ppo.update_step(cfg, ts)
    assert all(torch.isfinite(v) for v in m.values())
    assert ts.update_idx == 1 and ts.global_step == cfg.batch_size
    if cfg.search_static:
        assert int((ts.opp_idx == sent).sum()) == cfg.n_search_static
    assert int(ts.opp_idx.max()) <= sent


def test_league_slot_episodes_stay_out_of_the_pfsp_counts():
    """pfsp sampling with the static slot: the counts account for every
    finished episode but those of the sentinel rows."""
    cfg = tiny_cfg(search_static=True, p_search=0.25, num_steps=48, opponent_sampling="pfsp",
                   total_timesteps=16 * 48 * 6)
    ts = ppo.init_train_state(cfg, device="cpu")
    ts, traj = ppo.rollout(cfg, ts)
    static = ppo._static_sentinel_rows(cfg, cfg.num_envs, "cpu")
    assert int(traj.done[:, static].sum()) > 0
    assert ts.pool.games.sum().item() == int(traj.done[:, ~static].sum()) > 0


def test_train_cli_flags_reach_the_config():
    cfg = train.parse_args(["--search-opponent", "--search-static", "--search-censored",
                            "--p-search", "0.2", "--search-m", "16", "--search-k0", "3",
                            "--search-horizon", "5", "--rng-mode", "parity"])
    assert (cfg.search_opponent, cfg.search_static, cfg.search_censored, cfg.p_search, cfg.search_m,
            cfg.search_k0, cfg.search_horizon, cfg.rng_mode) == (True, True, True, 0.2, 16, 3, 5,
                                                                 "parity")
    ppo._check_supported(cfg)
    off = train.parse_args([])
    assert not (off.search_opponent or off.search_static or off.search_censored)
    assert (off.p_search, off.search_m, off.search_k0, off.search_horizon, off.rng_mode) == (
        0.125, 8, 4, 2, "fast")


def test_league_forwards_run_the_fused_forward(monkeypatch):
    """Per turn of the static league the fused forward is called for the
    agent, for each pool slot with games, and 1 + rounds * (horizon + 1)
    times by the search (root prior; per halving round `horizon` playout
    plies without the value and one leaf evaluation of the critic alone)."""
    from splendax_torch.search import mc

    cfg = tiny_cfg(search_static=True, p_search=0.25)
    ts = ppo.init_train_state(cfg, device="cpu")
    calls = []
    real, real_value = fac.fused_masked_forward_plain, mc.fused_value_forward

    def counting(weights, obs, mask, with_value=True):
        calls.append((obs.shape[0], with_value))
        return real(weights, obs, mask, with_value)

    def counting_value(weights, obs):
        calls.append((obs.shape[0], "critic"))
        return real_value(weights, obs)

    monkeypatch.setattr(fac, "fused_masked_forward_plain", counting)
    monkeypatch.setattr(mc, "fused_value_forward", counting_value)
    pool = pool_lib.set_current(ts.pool, ts.params)
    r = ring.make_ring(2 * cfg.num_envs, ts.generator, "cpu", window=cfg.num_envs)
    ppo.rollout_turn(cfg, ac.kernel_weights(ts.params), pool, ts.env_state, ts.obs, ts.mask,
                     ts.opp_idx, r, ts.generator)
    S_rows, lanes = cfg.n_search_static, cfg.n_search_static * cfg.search_m * cfg.search_k0
    rounds = cfg.search_m.bit_length() - 1
    search_calls = [(S_rows, False)] + rounds * (cfg.search_horizon * [(lanes, False)]
                                                  + [(lanes, "critic")])
    # The empty pool puts every other game on CURRENT: one slot forward.
    assert calls == [(16, True), (16 - S_rows, False)] + search_calls

"""The port's searches (`splendax_torch.search`) against the JAX package on
the CPU: flat Monte Carlo and the Gumbel search here, with the tests that
run every search; determinize and PUCT in `test_torch_search_ismc_uct.py`.
The same mid-game states, made with a seed, and the JAX function's own
random draws, derived from its key with `jax.random` and passed to the port.

Tolerances.  Without a network (uniform prior, uniform playouts, prestige
leaves) everything is exact: leaf values, determinized states, playout
values, Q tables, actions, PUCT root counts and values.  With a network
(H=32) values agree within 1e-5 (f32 sums in another order) and actions
agree on every row that is not a near-tie (see `near_tie_rows`)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.engine.types import GameState as JGameState
from splendax.search import gumbel as jgumbel
from splendax.search import ismc as jismc
from splendax.search import mc as jmc
from splendax.search import uct as juct
from splendax_torch import search
from splendax_torch.engine import rules, state as S
from splendax_torch.engine.encode import encode_observation
from splendax_torch.env import core
from splendax_torch.models import actor_critic as ac
from splendax_torch.search import gumbel, ismc, mc
from splendax_torch.selfplay.opponents import uniform_legal_action
from test_torch_rollout import jax_params, numpy_params

H, A = 32, 45


def midgame(B, plies, seed):
    """B games after `plies` uniformly random legal plies (frozen once
    over), on the CPU: reachable states with reserves, refills, spent decks."""
    g = torch.Generator().manual_seed(seed)
    st, _, mask = core.reset(B, g, "cpu")
    for _ in range(plies):
        term = rules.is_terminal(st)
        nxt, _ = core.step_core(st, uniform_legal_action(mask, g), mask=mask)
        st = core.select(term, st, nxt)
        mask = rules.legal_mask(st)
    return st, encode_observation(st), mask


def to_jax(st):
    return JGameState(**{k: jnp.asarray(v) for k, v in S.to_numpy(st).items()})


def jax_inputs(st, obs, mask):
    return to_jax(st), jnp.asarray(obs.numpy()), jnp.asarray(mask.numpy())


def assert_states_equal(got, want, msg=""):
    got = S.to_numpy(got)
    for k in S.FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=f"{msg} {k}")


def t(x):
    return torch.from_numpy(np.array(x))


def legal(mask, action):
    """Every action is legal, bar the games that have no legal action."""
    return bool((mask.gather(1, action[:, None])[:, 0] | ~mask.any(1)).all())


@functools.lru_cache(maxsize=None)
def nets():
    """One H=32 network in both packages: (JAX params, the port's ctx)."""
    flat = numpy_params(np.random.RandomState(11), H)
    return jax_params(flat), ac.kernel_weights(ac.params_from_jax(flat, device="cpu"))


def both_ctx(net):
    return nets() if net else (None, None)


def blind_reserves(st):
    """bool [B]: the opponent of the mover holds a blind reserve."""
    ar = torch.arange(st.batch_size)
    opp = 1 - st.to_play.long()
    slot = torch.arange(3)[None] < st.reserved_count[ar, opp][:, None]
    return (slot & (st.reserved_revealed[ar, opp] == 0) & (st.reserved_ids[ar, opp] >= 0)).any(1)


# ---- the JAX functions' own draws, from their keys --------------------------

def playout_draws(key, horizon, N, guided):
    """`mc.rollout_values`: one key a ply; the guided move is
    `jax.random.categorical`, the argmax of logits + Gumbel noise [N, 45];
    the unguided one reads one uniform a lane."""
    out = []
    for k in jax.random.split(key, horizon):
        if guided:
            out.append(t(jax.random.gumbel(k, (N, A))))
        else:
            out.append(t(jax.random.uniform(k, (N, 1))[:, 0]))
    return out


def det_uniforms(keys):
    """`ismc.determinize` on each key: three sub-keys, 43 uniforms each."""
    one = lambda k: jax.vmap(lambda kk: jax.random.uniform(kk, (ismc.EXT,)))(jax.random.split(k, 3))
    return t(jax.vmap(one)(keys))


def gumbel_draws(key, B, m, k0, horizon, guided, censored):
    k_gumbel, k_play, k_det = jax.random.split(key, 3)
    rounds = m.bit_length() - 1
    draws = {"g": t(jax.random.gumbel(k_gumbel, (B, A))),
             "playout": [playout_draws(jax.random.fold_in(k_play, r), horizon, B * m * k0, guided)
                         for r in range(rounds)]}
    if censored:
        draws["det"] = [det_uniforms(jax.random.split(jax.random.fold_in(k_det, r),
                                                      B * (m * k0 // (m >> r))))
                        for r in range(rounds)]
    return draws


def test_categorical_is_gumbel_argmax():
    """The premise of `playout_draws`: `jax.random.categorical(key, logits)`
    is the argmax of logits + `jax.random.gumbel(key, logits.shape)`."""
    key = jax.random.PRNGKey(0)
    logits = jax.random.normal(jax.random.PRNGKey(1), (256, A))
    want = jax.random.categorical(key, logits)
    got = jnp.argmax(logits + jax.random.gumbel(key, logits.shape), axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---- leaves -----------------------------------------------------------------

@pytest.mark.parametrize("net", [False, True])
def test_leaf_values_match_jax(net):
    """Exact without a net, 1e-5 with one; live and finished games, both
    seats as the searcher."""
    jctx, ctx = both_ctx(net)
    st, _, _ = midgame(96, 60, 1)
    term = rules.is_terminal(st)
    assert term.any() and (~term).any()
    me = torch.from_numpy(np.random.RandomState(2).randint(0, 2, 96)).to(torch.int32)
    # Under jit, as the searches run it: XLA compiles lead / 15 to a product.
    want = np.asarray(jax.jit(lambda s, m: jmc.leaf_values(s, m, jctx))(
        to_jax(st), jnp.asarray(me.numpy())))
    got = mc.leaf_values(st, me, ctx).numpy()
    if net:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[term.numpy()], want[term.numpy()])
    else:
        np.testing.assert_array_equal(got, want)
    assert np.abs(got[~term.numpy()]).max() <= 0.95


def two_head_value(weights, obs):
    """A leaf's value as the two-head forward gives it: through an all-true
    mask, the logits dropped."""
    every = torch.ones((obs.shape[0], A), dtype=torch.bool, device=obs.device)
    return mc.fused_masked_forward(weights, obs, every, with_value=True)[1]


@pytest.mark.parametrize("handle", [False, True])
def test_leaf_values_take_the_critic_alone(handle, monkeypatch):
    """`leaf_values` scores live leaves with the critic alone
    (`fused_value_forward`): the same values, bit for bit, as with the
    two-head forward's value, live and finished games, both seats, on the
    weights as a list or a `PreparedWeights` handle; on the CPU no forward
    of the critic alone is counted."""
    from splendax_torch.ops import fused_actor_critic as fac

    ctx = nets()[1]
    ctx = mc.as_ctx(ctx) if handle else ctx
    st, _, _ = midgame(96, 60, 1)
    me = torch.from_numpy(np.random.RandomState(2).randint(0, 2, 96)).to(torch.int32)
    before = fac.critic_launches
    got = mc.leaf_values(st, me, ctx)
    assert fac.critic_launches == before
    monkeypatch.setattr(mc, "fused_value_forward", two_head_value)
    assert torch.equal(got, mc.leaf_values(st, me, ctx))


@pytest.mark.parametrize("algo", ["gumbel", "cgumbel", "mc"])
def test_searches_with_the_critic_alone_play_as_before(algo, monkeypatch):
    """With a net on fixed draws, the Gumbel search (plain and censored) and
    flat MC, whose leaves take the critic alone, give the same actions and
    the same values, bit for bit, as with the two-head forward's value at
    the leaves."""
    _, ctx = nets()
    B = 16 if algo == "mc" else 32
    st, obs, mask = midgame(B, 41, 21)
    key = jax.random.PRNGKey(23)
    if algo == "mc":
        draws = playout_draws(key, 2, B * A * 2, True)
        q_fn = mc.mc_search_q(rollouts=2, horizon=2)

        def run():
            return q_fn(ctx, obs, mask, st, draws=draws), {}
    else:
        censored = algo == "cgumbel"
        draws = gumbel_draws(key, B, M, K0, HZ, True, censored)
        fn = port_gumbel(ctx, censored, False)

        def run():
            info = {}
            return fn(ctx, obs, mask, st, draws=draws, info=info), info
    got, info = run()
    monkeypatch.setattr(mc, "fused_value_forward", two_head_value)
    want, info_want = run()
    assert torch.equal(got, want)
    for k in ("cand", "alive", "q_hat", "final"):
        if k in info:
            assert torch.equal(info[k], info_want[k]), k


# ---- playouts and Q tables ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jit_rollout_values(net, horizon):
    jctx = nets()[0] if net else None
    return jax.jit(lambda st, me, key: jmc.rollout_values(st, me, jctx, key, horizon))


@pytest.mark.parametrize("net", [False, True])
def test_rollout_values_match_jax(net):
    """3 plies from 128 lanes late in their games, some of them over."""
    _, ctx = both_ctx(net)
    st, _, _ = midgame(128, 60, 7)
    term = rules.is_terminal(st)
    assert term.any() and (~term).any()  # finished lanes stay frozen
    me = (torch.arange(128) % 2).to(torch.int32)
    key = jax.random.PRNGKey(8)
    want = np.asarray(jit_rollout_values(net, 3)(to_jax(st), jnp.asarray(me.numpy()), key))
    got = mc.rollout_values(st, me, ctx, None, 3, draws=playout_draws(key, 3, 128, net)).numpy()
    if net:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def jit_q(censored, net, rollouts, horizon):
    jctx = nets()[0] if net else None
    make = jismc.censored_mc_q if censored else jmc.mc_search_q
    fn = make(rollouts, horizon)
    return jax.jit(lambda obs, mask, st, key: fn(jctx, obs, mask, st, key))


@pytest.mark.parametrize("censored", [False, True])
@pytest.mark.parametrize("net", [False, True])
def test_mc_q_matches_jax(net, censored):
    """`mc_search_q` and `censored_mc_q`, 3 playouts of 2 plies on 8 games:
    the Q table and the policy's action."""
    B, K, hz = 8, 3, 2
    _, ctx = both_ctx(net)
    st, obs, mask = midgame(B, 41, 9)
    key = jax.random.PRNGKey(10)
    want = np.asarray(jit_q(censored, net, K, hz)(*jax_inputs(st, obs, mask)[1:],
                                                  to_jax(st), key))
    if censored:
        k_det, k_play = jax.random.split(key)
        draws = {"det": det_uniforms(jax.random.split(k_det, B * K)),
                 "playout": playout_draws(k_play, hz, B * K * A, net)}
        q_fn, (policy, pctx) = ismc.censored_mc_q(K, hz), search.censored_mc_policy(K, hz, ctx)
    else:
        draws = playout_draws(key, hz, B * A * K, net)
        q_fn, (policy, pctx) = mc.mc_search_q(K, hz), search.mc_search_policy(K, hz, ctx)
    got = q_fn(ctx, obs, mask, st, draws=draws).numpy()
    legal = mask.numpy()
    assert np.isneginf(got[~legal]).all() and np.isneginf(want[~legal]).all()
    if net:
        np.testing.assert_allclose(got[legal], want[legal], rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
        action = policy(pctx, obs, mask, st, draws=draws)
        np.testing.assert_array_equal(action.numpy(), want.argmax(-1))


# ---- Gumbel sequential halving ----------------------------------------------------

M, K0, HZ = 4, 2, 2


@functools.lru_cache(maxsize=None)
def jit_gumbel(net, censored, greedy_final, m=M):
    jctx = nets()[0] if net else None
    fn = jgumbel.gumbel_search_fn(m=m, k0=K0, horizon=HZ, greedy_final=greedy_final,
                                  determinize_fn=jismc.determinize if censored else None)
    return jax.jit(lambda obs, mask, st, key: fn(jctx, obs, mask, st, key))


def port_gumbel(ctx, censored, greedy_final, m=M):
    return gumbel.gumbel_search_fn(m=m, k0=K0, horizon=HZ, greedy_final=greedy_final,
                                   determinize_fn=ismc.determinize if censored else None)


def near_tie_rows(info, gap=1e-4):
    """Rows that a difference of 1e-5 in a value could decide otherwise: the
    two best final scores, or the scores either side of a halving cut, lie
    within `gap`.  The JAX search returns its action only, so the scores are
    the port's, which are within 1e-5 of JAX's."""
    near = torch.zeros(info["final"].shape[0], dtype=torch.bool)
    for score, keep in info["cuts"] + [(info["final"], 1)]:
        s = torch.sort(score, dim=-1, descending=True).values
        near |= (s[:, keep - 1] - s[:, keep]).abs() < gap  # -inf - -inf is nan: not near
    return near


@pytest.mark.parametrize("censored,greedy_final", [(False, False), (True, False), (False, True)])
def test_gumbel_search_matches_jax_without_a_net(censored, greedy_final):
    """Exact actions on 32 games, m=4 k0=2 horizon 2."""
    B = 32
    st, obs, mask = midgame(B, 41, 12)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jit_gumbel(False, censored, greedy_final)(*jax_inputs(st, obs, mask)[1:],
                                                               to_jax(st), key))
    draws = gumbel_draws(key, B, M, K0, HZ, False, censored)
    got = port_gumbel(None, censored, greedy_final)(None, obs, mask, st, draws=draws)
    np.testing.assert_array_equal(got.numpy(), want)
    assert legal(mask, got)


@pytest.mark.parametrize("censored,greedy_final", [(False, False), (True, True)])
def test_gumbel_search_matches_jax_with_a_net(censored, greedy_final):
    """Actions equal on every row that is not a near-tie; at most 5% of the
    64 rows may be set aside."""
    B = 64
    jctx, ctx = nets()
    st, obs, mask = midgame(B, 41, 14)
    key = jax.random.PRNGKey(15)
    want = np.asarray(jit_gumbel(True, censored, greedy_final)(*jax_inputs(st, obs, mask)[1:],
                                                              to_jax(st), key))
    draws = gumbel_draws(key, B, M, K0, HZ, True, censored)
    info = {}
    got = port_gumbel(ctx, censored, greedy_final)(ctx, obs, mask, st, draws=draws, info=info)
    aside = near_tie_rows(info).numpy()
    print(f"gumbel with a net (censored={censored}, greedy_final={greedy_final}): "
          f"{aside.sum()} of {B} rows set aside as near-ties")
    assert aside.mean() <= 0.05
    np.testing.assert_array_equal(got.numpy()[~aside], want[~aside])
    assert legal(mask, got)


def test_gumbel_fewer_legal_actions_than_m():
    """m=32 exceeds every game's legal count: padded slots score -inf, sort
    last and never win.  Exact against JAX."""
    B = 16
    st, obs, mask = midgame(B, 41, 16)
    assert int(mask.sum(1).max()) < 32
    key = jax.random.PRNGKey(17)
    want = np.asarray(jit_gumbel(False, False, False, m=32)(*jax_inputs(st, obs, mask)[1:],
                                                            to_jax(st), key))
    info = {}
    got = port_gumbel(None, False, False, m=32)(
        None, obs, mask, st, draws=gumbel_draws(key, B, 32, K0, HZ, False, False), info=info)
    np.testing.assert_array_equal(got.numpy(), want)
    assert legal(mask, got)
    assert not mask.gather(1, info["cand"]).all()  # there were padded slots
    assert not (info["alive"] & ~mask.gather(1, info["cand"])).any()  # none of them survived
    assert (info["alive"].sum(1) == 2 * mask.any(1)).all()


def test_gumbel_exact_ties_break_as_in_jax(monkeypatch):
    """Gumbel noise rounded to whole numbers under a uniform prior: equal
    scores at the root, at the halving cuts and in the final argmax.  Which
    of two equal slots survives is fixed by the stable sorts; exact against
    JAX, whose `jax.random.gumbel` is rounded the same way while it traces."""
    B = 64
    st, obs, mask = midgame(B, 41, 18)
    key = jax.random.PRNGKey(19)
    real = jax.random.gumbel
    monkeypatch.setattr(jax.random, "gumbel", lambda *a, **k: jnp.round(real(*a, **k)))
    fn = jgumbel.gumbel_search_fn(m=8, k0=1, horizon=1)
    want = np.asarray(jax.jit(lambda o, m_, s, k: fn(None, o, m_, s, k))(
        *jax_inputs(st, obs, mask)[1:], to_jax(st), key))
    monkeypatch.undo()
    draws = gumbel_draws(key, B, 8, 1, 1, False, False)
    draws["g"] = torch.round(draws["g"])
    info = {}
    got = gumbel.gumbel_search_fn(m=8, k0=1, horizon=1)(None, obs, mask, st, draws=draws,
                                                       info=info)
    np.testing.assert_array_equal(got.numpy(), want)
    tied = 0
    for score, keep in info["cuts"] + [(info["final"], 1)]:
        s = torch.sort(score, dim=-1, descending=True).values
        tied += int((s[:, keep - 1] == s[:, keep]).sum())
    assert tied >= 8, tied  # the ties were there to be broken


def test_root_candidates_match_jax_on_ties():
    """Tied and -inf scores: the same slots in the same order, the prior's
    argmax first."""
    rng = np.random.RandomState(20)
    B = 64
    logits = np.round(rng.randn(B, A) * 2).astype(np.float32)
    mask = rng.rand(B, A) < 0.3
    mask[:, 7] = True
    g = np.round(rng.gumbel(size=(B, A))).astype(np.float32)
    gscore = np.where(mask, g + logits, -np.inf).astype(np.float32)
    for m in (2, 8, 32):
        want = jgumbel._root_candidates(jnp.asarray(gscore), jnp.asarray(logits),
                                        jnp.asarray(mask), m)
        got = gumbel._root_candidates(torch.from_numpy(gscore), torch.from_numpy(logits),
                                      torch.from_numpy(mask), m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_prior_logits_serve(monkeypatch):
    """The JAX search adds the noise to the unmasked logits and masks after;
    the port's fused forward returns them masked.  Every read is at a legal
    action, so the search is the same with either."""
    _, ctx = nets()
    st, obs, mask = midgame(32, 41, 21)
    draws = gumbel_draws(jax.random.PRNGKey(22), 32, M, K0, HZ, True, False)
    fn = port_gumbel(ctx, False, True)
    info_masked, info_raw = {}, {}
    a_masked = fn(ctx, obs, mask, st, draws=draws, info=info_masked)

    def unmasked(weights, obs, mask, with_value=True):
        return mc.fused_masked_forward(weights, obs, torch.ones_like(mask), with_value)

    monkeypatch.setattr(gumbel, "fused_masked_forward", unmasked)
    a_raw = fn(ctx, obs, mask, st, draws=draws, info=info_raw)
    assert torch.equal(a_masked, a_raw)
    for k in ("cand", "alive", "q_hat", "final"):
        assert torch.equal(info_masked[k], info_raw[k]), k


def test_gumbel_rejects_bad_m():
    for bad in (0, 1, 3, 6, 12, 64):
        with pytest.raises(ValueError):
            search.gumbel_search_policy(m=bad)
        with pytest.raises(ValueError):
            jgumbel.gumbel_search_fn(m=bad)


def test_names_and_privileged_flags_match_jax():
    net = ac.params_from_jax(numpy_params(np.random.RandomState(0), 8), device="cpu")
    pairs = [
        (search.mc_search_policy(3, 5), jmc.mc_search_policy(3, 5)),
        (search.censored_mc_policy(3, 5), jismc.censored_mc_policy(3, 5)),
        (search.uct_search_policy(9), juct.uct_search_policy(9)),
        (search.gumbel_search_policy(8, 3, 2, greedy_final=True),
         jgumbel.gumbel_search_policy(8, 3, 2, greedy_final=True)),
        (search.censored_gumbel_policy(8, 3, 2), jismc.censored_gumbel_policy(8, 3, 2)),
        ((mc.mc_search_q(3, 5), None), (jmc.mc_search_q(3, 5), None)),
        ((search.censored_mc_q(3, 5), None), (jismc.censored_mc_q(3, 5), None)),
    ]
    for (fn, ctx), (jfn, _) in pairs:
        assert fn.__name__ == jfn.__name__ and fn.privileged == jfn.privileged, fn.__name__
        assert ctx is None
    fn, ctx = search.mc_search_policy(1, 1, net)
    assert len(ctx) == 12 and all(torch.equal(a, b) for a, b in zip(ctx, ac.kernel_weights(net)))
    import splendax.search as jsearch

    public = lambda mod: {n for n in dir(mod) if not n.startswith("_") and callable(getattr(mod, n))}
    assert public(jsearch) <= public(search)


# ---- every search -----------------------------------------------------------------

def forced_win_state():
    """Player 0 at 14 prestige with one 1-point card on the board and the
    tokens to buy it: action 15 wins on the spot."""
    st = S.initial_state_parity(3, "cpu")
    st.prestige[0] = torch.tensor([14, 0], dtype=torch.int32)
    st.tokens[0, 0] = torch.tensor([7, 7, 7, 7, 7, 3], dtype=torch.int32)
    st.board[:] = -1
    st.board[0, 0, 0] = 7
    return st


def policy_action(spec, st, seed=0):
    fn, ctx = spec
    return int(fn(ctx, encode_observation(st), rules.legal_mask(st), st,
                  torch.Generator().manual_seed(seed))[0])


@pytest.mark.parametrize("algo,net", [(a, n) for a in ("mc", "cmc", "uct", "gumbel", "cgumbel",
                                                       "gumbel_gf")
                                      for n in (False, True) if (a, n) != ("uct", True)])
def test_search_picks_the_forced_win(algo, net):
    """The fixtures of the JAX package's search tests: only the winning buy
    is a proven +1; every live leaf is clipped below it.  (PUCT with a net
    follows the critic after one visit a move; it is held against JAX in
    `test_uct_with_a_net_matches_jax`.)"""
    params = ac.params_from_jax(numpy_params(np.random.RandomState(1), H), "cpu") if net else None
    spec = {
        "mc": lambda: search.mc_search_policy(1, 1, params),
        "cmc": lambda: search.censored_mc_policy(1, 1, params),
        "uct": lambda: search.uct_search_policy(24, params),
        "gumbel": lambda: search.gumbel_search_policy(32, 2, 1, params, c_scale=1000.0),
        "cgumbel": lambda: search.censored_gumbel_policy(16, 2, 1, params, c_scale=100.0),
        "gumbel_gf": lambda: search.gumbel_search_policy(16, 2, 1, params, c_scale=100.0,
                                                         greedy_final=True),
    }[algo]()
    st = forced_win_state()
    assert bool(rules.legal_mask(st)[0, 15])
    assert policy_action(spec, st) == 15


def test_playout_ply_freezes_finished_games():
    st = forced_win_state()
    won = rules.apply_action(st, torch.tensor([15]))
    won = rules.apply_action(won, torch.argmax(rules.legal_mask(won).int(), -1))
    assert bool(rules.is_terminal(won))
    frozen = won
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        frozen = mc.playout_ply(frozen, g)
    for k, v in won.items():
        assert torch.equal(getattr(frozen, k), v), k
    assert mc.leaf_values(won, torch.tensor([0])).item() == 1.0
    assert mc.leaf_values(won, torch.tensor([1])).item() == -1.0


@pytest.mark.parametrize("algo", ["mc", "cmc", "uct", "gumbel", "cgumbel"])
def test_search_actions_are_legal_from_a_generator(algo):
    """Drawing from a generator, with a net: legal actions, and the same
    seed gives the same actions."""
    _, ctx = nets()
    spec = {
        "mc": search.mc_search_policy(2, 2, ctx), "cmc": search.censored_mc_policy(2, 2, ctx),
        "uct": search.uct_search_policy(8, ctx, max_depth=4),
        "gumbel": search.gumbel_search_policy(4, 2, 2, ctx),
        "cgumbel": search.censored_gumbel_policy(4, 2, 2, ctx, greedy_final=True),
    }[algo]
    st, obs, mask = midgame(16, 30, 24)
    fn, c = spec
    a = fn(c, obs, mask, st, torch.Generator().manual_seed(3))
    b = fn(c, obs, mask, st, torch.Generator().manual_seed(3))
    assert a.dtype == torch.int64 and torch.equal(a, b)
    assert legal(mask, a)


def test_gumbel_search_beats_random():
    """Without a net (prestige-lead leaves) the Gumbel search still beats a
    uniformly random opponent, through the eval suite."""
    from splendax_torch.eval import suite

    res = suite.eval_vs_opponent(search.gumbel_search_policy(m=8, k0=2, horizon=6),
                                 suite.heuristic_policy("random"), n_games=24, seed=2,
                                 device="cpu")
    assert res["win_rate"] > 0.7, res
    assert res["privileged"] == {"agent": True, "opponent": False}

"""The port's information-set determinization (`search/ismc.determinize`)
and PUCT search (`search/uct.py`) against the JAX package on the CPU, as
`test_torch_search.py` holds flat Monte Carlo and the Gumbel search: the
same mid-game states and JAX's own draws.  Exact without a network; with
the H=32 network values within 1e-5."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.search import ismc as jismc
from splendax.search import uct as juct
from splendax_torch import search
from splendax_torch.engine import rules, state as S
from splendax_torch.engine.encode import encode_observation
from splendax_torch.search import ismc, uct
from test_torch_search import (A, assert_states_equal, blind_reserves, both_ctx, det_uniforms,
                               forced_win_state, midgame, nets, policy_action, to_jax)


@pytest.mark.parametrize("net", [False, True])
def test_uct_leaf_eval_matches_jax(net):
    """`_leaf_eval`: mask and terminal flag exact; prior and value pair
    exact without a net, 1e-5 with one."""
    jctx, ctx = both_ctx(net)
    st, _, _ = midgame(96, 60, 3)
    jp, jv, jt, jm = jax.jit(jax.vmap(lambda s: juct._leaf_eval(s, jctx)))(to_jax(st))
    prior, value2, term, mask = uct._leaf_eval(st, ctx)
    np.testing.assert_array_equal(term.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert term.any() and (~term).any()
    if net:
        np.testing.assert_allclose(prior.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(value2.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(prior.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(value2.numpy(), np.asarray(jv))


def test_puct_scores_match_jax():
    """Exact: visited and unvisited edges, first-play urgency, illegal
    actions at -inf."""
    rng = np.random.RandomState(4)
    B = 64
    mask = rng.rand(B, A) < 0.4
    prior = (rng.rand(B, A) * mask).astype(np.float32)
    n_sa = (rng.randint(0, 5, (B, A)) * mask).astype(np.float32)
    w_sa = (rng.randn(B, A) * n_sa).astype(np.float32)
    fpu = rng.uniform(-0.95, 0.95, B).astype(np.float32)
    want = jax.vmap(lambda p, n, w, m, f: juct._puct_scores(p, n, w, m, 1.5, f))(
        *map(jnp.asarray, (prior, n_sa, w_sa, mask, fpu)))
    got = uct._puct_scores(*map(torch.from_numpy, (prior, n_sa, w_sa, mask)), 1.5,
                           torch.from_numpy(fpu))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- determinize ---------------------------------------------------------------


def test_determinize_matches_jax():
    """All 18 fields equal to JAX's on the same uniforms, on states with and
    without blind reserves; the observation and the legal mask unchanged."""
    st, obs, mask = midgame(64, 41, 5)
    blind = blind_reserves(st)
    assert blind.any() and (~blind).any()
    keys = jax.random.split(jax.random.PRNGKey(6), 64)
    want = jax.vmap(jismc.determinize)(to_jax(st), keys)
    got = ismc.determinize(st, u=det_uniforms(keys))
    assert_states_equal(got, want)
    assert not torch.equal(got.deck_perm, st.deck_perm)
    assert not torch.equal(got.reserved_ids, st.reserved_ids)
    assert torch.equal(encode_observation(got), obs)
    assert torch.equal(rules.legal_mask(got), mask)
    # Drawn from a generator it is a permutation of the same pools too.
    own = ismc.determinize(st, torch.Generator().manual_seed(0))
    assert torch.equal(encode_observation(own), obs)
    assert torch.equal(own.deck_perm.sort(-1).values, st.deck_perm.sort(-1).values) or blind.any()


def test_determinize_is_the_identity_without_hidden_information():
    st = S.initial_state_parity(5, "cpu")
    st = st.replace(deck_count=torch.zeros_like(st.deck_count),
                    deck_perm=torch.full_like(st.deck_perm, -1))
    det = ismc.determinize(st, torch.Generator().manual_seed(0))
    for k, v in st.items():
        assert torch.equal(getattr(det, k), v), k


# ---- PUCT ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jit_uct(sims, depth):
    return jax.jit(jax.vmap(lambda s: juct._uct_one_game(s, None, sims, depth, 1.5)))


@pytest.mark.parametrize("sims", [8, 16])
def test_uct_root_counts_match_jax(sims):
    """Root visit counts and Q exactly equal without a net, 16 mid-game
    trees of depth 8; every simulation backs up through the root."""
    st, _, mask = midgame(16, 41, 23)
    jn, jq = jit_uct(sims, 8)(to_jax(st))
    n, q = uct.uct_search(st, None, sims, 8, 1.5)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert (n.sum(1) == sims).all() and not (n > 0)[~mask].any()


def test_uct_with_a_net_matches_jax():
    """Root counts equal and Q within 1e-5 with the H=32 net, 16 sims, on
    the forced-win fixture and 15 mid-game trees."""
    jctx, ctx = nets()
    mid, _, _ = midgame(15, 41, 25)
    win = forced_win_state()
    st = S.GameState(**{k: torch.cat([v, getattr(mid, k)]) for k, v in win.items()})
    jn, jq = jax.jit(jax.vmap(lambda s: juct._uct_one_game(s, jctx, 16, 8, 1.5)))(to_jax(st))
    n, q = uct.uct_search(st, ctx, 16, 8, 1.5)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    seen = (n > 0).numpy()
    np.testing.assert_allclose(q.numpy()[seen], np.asarray(jq)[seen], rtol=1e-5, atol=1e-5)
    assert np.isneginf(q.numpy()[~seen]).all()


def test_uct_denies_the_opponents_forced_win():
    """Player 1 at 14 prestige can buy the one card on the board: every move
    of player 0 but reserving it (action 27) loses at depth 2."""
    st = S.initial_state_parity(3, "cpu")
    st.prestige[0] = torch.tensor([0, 14], dtype=torch.int32)
    st.tokens[0, 1] = torch.tensor([7, 7, 7, 7, 7, 0], dtype=torch.int32)
    st.board[:] = -1
    st.board[0, 0, 0] = 7
    st.deck_count[:] = 0  # no refill: reserving really denies the card
    mask = rules.legal_mask(st)[0]
    assert bool(mask[27]) and not bool(mask[39])
    assert policy_action(search.uct_search_policy(512, max_depth=8), st) == 27


def test_uct_turn_limit_draw_is_not_flipped_for_the_second_seat():
    """The turn-limit draw is -0.1 for both seats; with player 1 to move on
    the last ply every visited root Q is -0.1, not +0.1."""
    st = S.initial_state_parity(0, "cpu")
    st.move_count[:], st.turn_count[:], st.to_play[:] = 199, 100, 1
    mask = rules.legal_mask(st)
    nxt = rules.apply_action(st, torch.argmax(mask.int(), -1))
    assert bool(nxt.turn_limit_reached) and bool(rules.is_terminal(nxt))
    _, value2, term, _ = uct._leaf_eval(nxt, None)
    assert bool(term)
    np.testing.assert_allclose(value2.numpy(), [[-0.1, -0.1]])
    n, q = uct.uct_search(st, None, 16, 8, 1.5)
    visited = n[0] > 0
    assert visited.any()
    np.testing.assert_allclose(q[0][visited].numpy(), -0.1, atol=1e-6)

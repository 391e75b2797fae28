"""Parity mode of the port (`rng_mode="parity"`): its MT19937 against
CPython's `random`, its host-side deal against the JAX package's, and its
engine against the JAX engine in parity mode, ply by ply.  Everything here
is exact."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.engine.types import GameState as JGameState
from splendax.engine.types import initial_state_parity as j_initial_state_parity
from splendax.env import core as jcore
from splendax_torch.engine import mt19937 as mt
from splendax_torch.engine import rules, state as S
from splendax_torch.env import core

SEEDS = [0, 1, 42, 2654435761, 2**32, 131542391100, 2**38 - 1]  # below and above 2^32


def words(seeds):
    lo = torch.tensor([s & 0xFFFFFFFF for s in seeds], dtype=torch.int64)
    hi = torch.tensor([s >> 32 for s in seeds], dtype=torch.int64)
    return lo, hi


def test_mt19937_matches_cpython():
    """One lane a seed, 40 `_randbelow(n)` draws each with n in 1..5, and the
    raw 32-bit words of the first block."""
    ns = [5, 5, 3, 2, 4, 1, 5, 2, 3, 4] * 4
    stream = mt.init_from_seed_words(*words(SEEDS))
    for i, seed in enumerate(SEEDS):
        rng = random.Random(seed)
        assert stream[0][i, :8].tolist() == [rng.getrandbits(32) for _ in range(8)], seed
    got = []
    for n in ns:
        stream, r = mt.randbelow(stream, torch.full((len(SEEDS),), n))
        got.append(r.tolist())
    for i, seed in enumerate(SEEDS):
        assert [g[i] for g in got] == mt.py_randbelow_reference(seed, ns), seed


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_randbelow_matches_cpython_for_each_n(n):
    """200 draws of `_randbelow(n)` on 7 lanes: values and the stream
    position (rejections consume draws as CPython's do)."""
    stream = mt.init_from_seed_words(*words(SEEDS))
    rngs = [random.Random(s) for s in SEEDS]
    for _ in range(200):
        stream, r = mt.randbelow(stream, torch.full((len(SEEDS),), n))
        assert r.tolist() == [g._randbelow(n) for g in rngs]
    assert (stream[1] >= 200).all() and (stream[1] < mt.N).all()
    if n in (3, 5):
        assert (stream[1] > 200).any()  # some draw was rejected


def test_randbelow_inactive_lanes_consume_nothing():
    """Lanes take different n, and a lane that is done draws no more: each
    stream is consumed as its own `random.Random` is."""
    rs = np.random.RandomState(0)
    seeds = [int(s) for s in rs.randint(0, 2**31, 16)] + [2**33 + 5]
    stream = mt.init_from_seed_words(*words(seeds))
    rngs = [random.Random(s) for s in seeds]
    for _ in range(60):
        n = rs.randint(1, 6, len(seeds))
        active = rs.rand(len(seeds)) < 0.6
        stream, r = mt.randbelow(stream, torch.from_numpy(n), torch.from_numpy(active))
        want = [g._randbelow(int(k)) if a else 0 for g, k, a in zip(rngs, n, active)]
        assert r.tolist() == want
    # The streams are where CPython's are: the next draws agree too.
    stream, r = mt.randbelow(stream, torch.full((len(seeds),), 5))
    assert r.tolist() == [g._randbelow(5) for g in rngs]


def test_init_genrand_words_match_jax():
    from splendax.engine import mt19937 as jmt

    want = np.asarray(jmt._init_genrand(19650218)).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(mt._init_genrand_words(), np.int64), want)


@pytest.mark.parametrize("seed", [0, 3, 42, 999, 2**40 + 7])
def test_initial_state_parity_matches_jax(seed):
    """All 18 fields equal to the JAX package's deal, alone and in a batch."""
    want = j_initial_state_parity(seed)
    one = S.to_numpy(S.initial_state_parity(seed, "cpu"))
    batch = S.to_numpy(S.initial_state_parity([7, seed, 8], "cpu"))
    for k in S.FIELDS:
        w = np.asarray(getattr(want, k))
        np.testing.assert_array_equal(one[k][0], w, err_msg=k)
        np.testing.assert_array_equal(batch[k][1], w, err_msg=k)
        assert one[k].dtype == w.dtype, k


@jax.jit
def jax_parity_step(state, action):
    return jax.vmap(lambda s, a: jcore.step(s, a, rng_mode="parity"))(state, action)


def test_engine_in_parity_mode_matches_jax_over_full_games():
    """64 games from `initial_state_parity` deals, random legal play biased
    towards taking tokens, until every game is over: all 18 state fields,
    obs, mask, reward and the flags exact at every ply.  At least 50 games
    end, and the token cap is reached (a take from a full hand of 10)."""
    B = 64
    rng = np.random.RandomState(3)
    st = S.initial_state_parity(range(100, 100 + B), "cpu")
    js = JGameState(**{k: jnp.asarray(v) for k, v in S.to_numpy(st).items()})
    mask = rules.legal_mask(st)
    returns = plies = 0
    for ply in range(230):
        if bool(rules.is_terminal(st).all()):
            break
        m = mask.numpy() & ~rules.is_terminal(st).numpy()[:, None]
        w = rng.rand(B, 45) * m * np.where(np.arange(45) < 15, 3.0, 1.0)  # takes three times as likely
        a = np.where(m.any(1), w.argmax(1), 0)
        held = st.tokens[torch.arange(B), st.to_play.long()].sum(1).numpy()
        returns += int(((held == 10) & (a < 15) & m.any(1)).sum())
        st, out = core.step(st, torch.from_numpy(a), rng_mode="parity")
        js, jout = jax_parity_step(js, jnp.asarray(a, jnp.int32))
        got = S.to_numpy(st)
        for k in S.FIELDS:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)), err_msg=f"ply {ply} {k}")
        for k in ("obs", "action_mask", "reward", "terminated", "to_play", "illegal_action", "draw",
                  "turn_limit", "final_rewards"):
            np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(jout, k)),
                                          err_msg=f"ply {ply} {k}")
        mask = out.action_mask
        plies += 1
    over = int(rules.is_terminal(st).sum())
    print(f"parity engine: {plies} plies, {over} of {B} games over, {returns} takes from a full "
          f"hand of 10")
    assert over >= 50 and returns >= 50
    assert int((st.winner >= 0).sum()) > 0  # some games were won, not only drawn


def test_parity_and_fast_mode_differ_only_in_the_tokens_returned():
    """A take from a full hand: both modes return as many tokens, so the
    totals agree; which colours go back may differ.  A ply under the cap is
    the same in both modes."""
    st = S.initial_state_parity(range(8), "cpu")
    st.tokens[:, 0] = torch.tensor([2, 2, 2, 2, 2, 0], dtype=torch.int32)
    st.bank[:] = torch.tensor([2, 2, 2, 2, 2, 5], dtype=torch.int32)
    a = torch.zeros(8, dtype=torch.int64)  # a take-3
    fast = rules.apply_action(st, a, rng_mode="fast")
    par = rules.apply_action(st, a, rng_mode="parity")
    assert (fast.tokens[:, 0].sum(1) == 10).all() and (par.tokens[:, 0].sum(1) == 10).all()
    assert torch.equal(fast.bank.sum(1), par.bank.sum(1))
    fresh = S.initial_state_parity(range(8), "cpu")
    f2 = rules.apply_action(fresh, a, rng_mode="fast")
    p2 = rules.apply_action(fresh, a, rng_mode="parity")
    for k, v in f2.items():
        assert torch.equal(v, getattr(p2, k)), k
    with pytest.raises(ValueError, match="rng_mode"):
        rules.apply_action(fresh, a, rng_mode="exact")

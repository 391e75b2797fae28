"""The port's engine (`splendax_torch.engine`, `env.core`) against the JAX
engine: threefry bits, fresh deals, and lockstep fast-mode games compared
exactly on every ply."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.engine.types import GameState as JGameState
from splendax.env import core as jcore
from splendax_torch.engine import data as D
from splendax_torch.engine import rules, state as S
from splendax_torch.engine.threefry import uniform_from_key_words
from splendax_torch.env import core

STEP_OUT = ("obs", "reward", "terminated", "action_mask", "to_play", "illegal_action",
            "draw", "turn_limit", "final_rewards")


def test_threefry_uniform_bit_equal_to_jax():
    """Exact: `uniform_from_key_words` against `jax.random.uniform` on a
    threefry key, over 2,000+ random key pairs including top-bit words."""
    rng = np.random.RandomState(0)
    hi = rng.randint(0, 2**32, size=2500, dtype=np.uint64)
    lo = rng.randint(0, 2**32, size=2500, dtype=np.uint64)
    hi[:6] = [0, 2**32 - 1, 2**31, 0, 1, 2**31 + 5]
    lo[:6] = [0, 2**32 - 1, 0, 2**31, 1, 2**32 - 7]
    ref = jax.jit(jax.vmap(lambda h, l: jax.random.uniform(
        jax.random.wrap_key_data(jnp.stack([h, l]), impl="threefry2x32"), (12,))))(
        jnp.asarray(hi.astype(np.uint32)), jnp.asarray(lo.astype(np.uint32)))
    got = uniform_from_key_words(
        torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)), 12)
    np.testing.assert_array_equal(np.asarray(ref).view(np.uint32), got.numpy().view(np.uint32))


def test_initial_state_is_a_valid_deal():
    B = 256
    st = S.initial_state(B, torch.Generator().manual_seed(1), device="cpu")
    s = S.to_numpy(st)
    for t in range(3):
        n, off = int(D.TIER_SIZES[t]), int(D.TIER_OFFSETS[t])
        perm = s["deck_perm"][:, t, :n]
        np.testing.assert_array_equal(np.sort(perm, 1), np.broadcast_to(np.arange(off, off + n), (B, n)))
        assert (s["deck_perm"][:, t, n:] == -1).all()
        # board slot i holds the i-th pop from the deck's end
        np.testing.assert_array_equal(s["board"][:, t], perm[:, [n - 1, n - 2, n - 3, n - 4]])
        assert (s["deck_count"][:, t] == n - 4).all()
    nobles = s["noble_ids"]
    assert ((nobles >= 0) & (nobles < 10)).all()
    assert all(len(set(row)) == 3 for row in nobles.tolist())
    blank = S._blank_state_np()
    for k in ("bank", "tokens", "bonuses", "prestige", "reserved_ids", "reserved_count",
              "to_play", "turn_count", "move_count", "game_over", "winner"):
        assert (s[k] == blank[k]).all(), k
        assert s[k].dtype == np.asarray(blank[k]).dtype, k
    # all 18 fields carry the JAX dtypes and batched shapes
    for k, v in blank.items():
        assert s[k].shape == (B,) + np.shape(v), k


def test_default_device_is_the_gpu():
    """Entry points run on the card unless told otherwise; without one they
    raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.initial_state(4, torch.Generator())


def test_from_numpy_defaults_to_the_gpu():
    """`from_numpy` too runs on the card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    arrays = S.to_numpy(S.initial_state(2, torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.from_numpy(arrays)
    back = S.from_numpy(arrays, device="cpu")
    assert all(torch.equal(torch.as_tensor(arrays[k]), x) for k, x in back.items())


def _numpy_deals(rng, B):
    """B deals from numpy permutations, some lanes pushed near the token cap."""
    s = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
         for k, v in S._blank_state_np().items()}
    for b in range(B):
        for t in range(3):
            n, off = int(D.TIER_SIZES[t]), int(D.TIER_OFFSETS[t])
            perm = rng.permutation(n).astype(np.int32) + off
            s["deck_perm"][b, t, :n] = perm
            s["board"][b, t] = perm[[n - 1, n - 2, n - 3, n - 4]]
            s["deck_count"][b, t] = n - 4
        s["noble_ids"][b] = rng.permutation(10)[:3]
    # Lanes 0..15 start with both players holding 8-10 tokens, so the first
    # takes go over the cap and the token return runs.
    for b in range(16):
        for p in range(2):
            hand = np.zeros(6, np.int32)
            for _ in range(8 + b % 3):
                c = rng.choice(np.flatnonzero(s["bank"][b, :5] > 0))
                s["bank"][b, c] -= 1
                hand[c] += 1
            s["tokens"][b, p] = hand
    return s


def _jax_state(s):
    return JGameState(**{k: jnp.asarray(v) for k, v in s.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_lockstep_games_match_jax_exactly(seed):
    """64 lanes of fast-mode games played to their end in both engines with
    the same numpy actions (uniform over the legal mask, and 3% arbitrary,
    possibly illegal, actions): all 18 state fields and every StepOutput
    field equal on every ply."""
    B = 64
    rng = np.random.RandomState(seed)
    s = _numpy_deals(rng, B)
    pst, jst = S.from_numpy(s, device="cpu"), _jax_state(s)
    jstep = jax.jit(jax.vmap(jcore.step))
    ended = np.zeros(B, bool)
    returned = 0
    for ply in range(400):
        m = rules.legal_mask(pst).numpy()
        a = np.where(m.any(1), (rng.rand(B, 45) * m).argmax(1), 0)
        wild = rng.rand(B) < 0.03
        a = np.where(wild, rng.randint(0, 45, B), a).astype(np.int32)
        hand = S.to_numpy(pst)["tokens"].sum(-1)[np.arange(B), S.to_numpy(pst)["to_play"]]
        over_cap = (hand >= 10) & (a < 15) & m[np.arange(B), a]
        jst, jout = jstep(jst, jnp.asarray(a))
        pst, pout = core.step(pst, torch.from_numpy(a))
        ps = S.to_numpy(pst)
        for k in S.FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jst, k)), ps[k], err_msg=f"ply {ply} {k}")
        for k in STEP_OUT:
            np.testing.assert_array_equal(
                np.asarray(getattr(jout, k)), getattr(pout, k).numpy(), err_msg=f"ply {ply} {k}")
        returned += int(over_cap.sum())
        ended |= pout.terminated.numpy()
        if ended.all():
            break
    assert ended.all() and ended.sum() >= 50
    assert returned > 0  # the token return ran


def test_parity_mode_is_not_ported_yet():
    """(The name is from before parity mode was ported.)  `rng_mode="parity"`
    no longer raises: a ply under the token cap is the same in both modes
    (`tests/test_torch_parity.py` holds the mode against JAX); a mode that
    does not exist raises `ValueError`."""
    st = S.initial_state(2, torch.Generator().manual_seed(0), device="cpu")
    a = torch.zeros(2, dtype=torch.int64)
    parity = rules.apply_action(st, a, rng_mode="parity")
    fast = rules.apply_action(st, a, rng_mode="fast")
    for k, v in fast.items():
        assert torch.equal(v, getattr(parity, k)), k
    with pytest.raises(ValueError, match="rng_mode"):
        rules.apply_action(st, a, rng_mode="exact")

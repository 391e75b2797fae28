"""The engine's call sites on the CPU: the dual turn's, the Gumbel
search's and the playouts' ply functions equal the plain functions they
compose, and the dual turn and the playouts give the same bits with the
masks and observations their callers pass in as without.  The ply's
kernels at these sites are held on the card (`tests/test_torch_cuda.py`)."""

import dataclasses

import pytest
import torch

from splendax_torch.engine import rules
from splendax_torch.engine.encode import encode_observation
from splendax_torch.env import core
from splendax_torch.env import ring as ring_lib
from splendax_torch.search import gumbel, mc
from splendax_torch.selfplay import dual
from splendax_torch.selfplay.opponents import uniform_legal_action


def _games(B: int, plies: int, seed: int):
    """B games after `plies` uniformly random legal plies, an ended game
    dealt anew: (state, its legal mask, the generator)."""
    g = torch.Generator().manual_seed(seed)
    st, _, mask = core.reset(B, g, "cpu")
    for _ in range(plies):
        st, _, _, mask = core.step_autoreset(st, uniform_legal_action(mask, g), g, mask=mask)
    return st, mask, g


def _equal(a, b) -> bool:
    """a and b hold the same structure (tensors, None, tuples, dataclasses)
    and their tensors the same dtypes and bits."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(_equal(getattr(a, f.name), getattr(b, f.name))
                                          for f in dataclasses.fields(a))
    return a is None and b is None


@pytest.mark.parametrize("rng_mode", ["fast", "parity"])
def test_site_functions_equal_their_plain_compositions(rng_mode):
    """On CPU tensors, in both modes, the agent's ply is `core.step_plain`,
    the Gumbel root children `rules.apply_action_plain` on the repeated
    rows, and a playout step `core.step_core_plain` with finished lanes
    frozen and the successors' obs and legal masks: the same bits."""
    st, mask, g = _games(64, 30, 1)
    a = uniform_legal_action(mask, g)
    assert _equal(dual._agent_ply(st, a, mask, rng_mode=rng_mode),
                  core.step_plain(st, a, rng_mode=rng_mode, mask=mask))
    cand = torch.stack([a, (a + 1) % 45], 1)
    assert _equal(gumbel.children(st, cand, rng_mode=rng_mode),
                  rules.apply_action_plain(mc.repeat_rows(st, 2), cand.reshape(-1),
                                           rng_mode=rng_mode))
    nxt = core.select(rules.is_terminal(st), st,
                      core.step_core_plain(st, a, rng_mode=rng_mode, mask=mask)[0])
    want = (nxt, encode_observation(nxt), rules.legal_mask(nxt))
    assert _equal(mc.playout_step(st, a, mask, rng_mode=rng_mode), want)
    assert _equal(mc.playout_step(st, a, mask, rng_mode=rng_mode, with_obs=False),
                  (nxt, None, want[2]))


@pytest.mark.parametrize("rng_mode", ["fast", "parity"])
def test_dual_turn_with_the_masks_it_holds_equals_without(rng_mode):
    """The ring turn, the full-batch reset turn and the plain turn, given the
    state's legal mask, equal the same turns that recompute it; the
    opponent's ply takes the agent ply's next mask."""
    st, mask, g = _games(96, 40, 3)
    a = uniform_legal_action(mask, g)

    def policy(obs, m, state):
        return uniform_legal_action(m, torch.Generator().manual_seed(7))

    ring = ring_lib.make_ring(192, torch.Generator().manual_seed(5), "cpu", window=96)
    with_mask = dual.dual_step_autoreset_ring(st, a, policy, ring, rng_mode=rng_mode, mask=mask)
    without = dual.dual_step_autoreset_ring(st, a, policy, ring, rng_mode=rng_mode)
    assert _equal(with_mask[:5], without[:5]) and torch.equal(with_mask[5].ptr, without[5].ptr)
    fresh = core.reset(96, torch.Generator().manual_seed(6), "cpu")
    assert _equal(dual.dual_step_autoreset(st, a, policy, rng_mode=rng_mode, fresh=fresh,
                                           mask=mask),
                  dual.dual_step_autoreset(st, a, policy, rng_mode=rng_mode, fresh=fresh))
    assert _equal(dual.dual_step(st, a, policy, rng_mode=rng_mode, mask=mask),
                  dual.dual_step(st, a, policy, rng_mode=rng_mode))


@pytest.mark.parametrize("with_net", [False, True])
def test_playouts_with_given_obs_and_mask_equal_without(with_net):
    """`mc.rollout_values` from the lanes' obs and mask (as the Gumbel
    search's lanes pass them) equals the one that computes them."""
    from splendax_torch.models import actor_critic as ac

    st, mask, g = _games(48, 25, 4)
    ctx = mc.as_ctx(ac.ActorCritic(16, torch.Generator().manual_seed(0), "cpu")) if with_net else None
    me = st.to_play
    draws = [torch.rand(48, generator=g) for _ in range(3)]
    if with_net:
        draws = [ac.gumbel_noise((48, 45), g, "cpu") for _ in range(3)]
    obs = mc.observe(st, with_obs=with_net)[0]
    got = mc.rollout_values(st, me, ctx, None, 3, draws=draws, obs=obs, mask=mask)
    assert torch.equal(got, mc.rollout_values(st, me, ctx, None, 3, draws=draws))

"""`env/graphed` on the CPU: its calls run the eager functions and return
their bits; the dual turn and the playouts give the same bits with the masks
and observations their callers pass in as without.  The graphs themselves
are held on the card (`tests/test_torch_cuda.py`)."""

import pytest
import torch

from splendax_torch import trace
from splendax_torch.engine import rules
from splendax_torch.engine.state import GameState
from splendax_torch.env import core, graphed
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


def _leaves(x) -> list:
    out: list = []
    graphed._flatten(x, out)
    return out


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("rng_mode", ["fast", "parity"])
def test_calls_run_the_eager_functions_on_the_cpu(rng_mode):
    """On CPU tensors, in both modes, every call of every site (a key's
    first, second and third) runs its function: the same bits, no graph
    captured or replayed."""
    st, mask, g = _games(64, 30, 1)
    a = uniform_legal_action(mask, g)
    graphed.reset()
    before = {k: trace.counter(k) for k in ("graph.capture.dual.agent", "graph.replay.dual.agent")}
    for _ in range(3):
        got = graphed.call("dual.agent", dual._agent_ply, st, a, mask, rng_mode=rng_mode)
        assert _equal(got, core.step(st, a, rng_mode=rng_mode, mask=mask))
        cand = torch.stack([a, (a + 1) % 45], 1)
        kids = graphed.call("gumbel.children", gumbel.children, st, cand, rng_mode=rng_mode)
        assert _equal(kids, rules.apply_action(mc.repeat_rows(st, 2), cand.reshape(-1),
                                               rng_mode=rng_mode))
        nxt, obs, pmask = graphed.call("mc.playout", mc.playout_step, st, a, mask,
                                       rng_mode=rng_mode, with_obs=False)
        assert obs is None and torch.equal(pmask, rules.legal_mask(nxt))
    assert graphed.captured() == []
    assert {k: trace.counter(k) for k in before} == before


def test_structures_round_trip():
    """Tensors, None, tuples and dataclasses (a GameState, a StepOutput)
    flatten to their tensors and rebuild as they were; another leaf is
    refused."""
    st, mask, g = _games(8, 3, 2)
    nxt, out = core.step(st, uniform_legal_action(mask, g), mask=mask)
    x = (nxt, out, (mask, None, (mask,)))
    leaves: list = []
    spec = graphed._flatten(x, leaves)
    back = graphed._unflatten(spec, iter(leaves))
    assert isinstance(back[0], GameState) and type(back[1]) is type(out)
    assert back[2][1] is None and isinstance(back[2][2], tuple)
    assert _equal(back, x) and hash(spec) is not None
    for bad in ([mask], {"m": mask}, 3):
        with pytest.raises(TypeError, match="graphed"):
            graphed._flatten((bad,), [])


def test_dual_turn_with_the_masks_it_holds_equals_without():
    """The ring turn, the full-batch reset turn and the plain turn, given the
    state's legal mask, equal the same turns that recompute it; the
    opponent's ply takes the agent ply's next mask."""
    st, mask, g = _games(96, 40, 3)
    a = uniform_legal_action(mask, g)

    def policy(obs, m, state):
        return uniform_legal_action(m, torch.Generator().manual_seed(7))

    ring = ring_lib.make_ring(192, torch.Generator().manual_seed(5), "cpu", window=96)
    with_mask = dual.dual_step_autoreset_ring(st, a, policy, ring, mask=mask)
    without = dual.dual_step_autoreset_ring(st, a, policy, ring)
    assert _equal(with_mask[:5], without[:5]) and torch.equal(with_mask[5].ptr, without[5].ptr)
    fresh = core.reset(96, torch.Generator().manual_seed(6), "cpu")
    assert _equal(dual.dual_step_autoreset(st, a, policy, fresh=fresh, mask=mask),
                  dual.dual_step_autoreset(st, a, policy, fresh=fresh))
    assert _equal(dual.dual_step(st, a, policy, mask=mask), dual.dual_step(st, a, policy))


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
    obs = graphed.call("mc.observe", mc.observe, st, with_obs=with_net)[0]
    got = mc.rollout_values(st, me, ctx, None, 3, draws=draws, obs=obs, mask=mask)
    assert torch.equal(got, mc.rollout_values(st, me, ctx, None, 3, draws=draws))

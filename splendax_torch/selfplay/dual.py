"""Dual-step self-play: one call advances a whole turn, the agent's ply
(player 0) and then the opponent's (player 1), for a batch of games.

Counterpart of `splendax/selfplay/dual.py`, with its reward contract:
  * the game ends on the agent's move -> the agent gets that step's reward,
    the opponent final_rewards[1];
  * the game ends on the opponent's move -> the agent gets final_rewards[0],
    the opponent that step's reward;
  * the turn completes and the game goes on -> both get 0.

`opponent_policy(obs, mask, state) -> action [B]` acts on the whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .. import trace
from ..engine import rules
from ..engine.encode import encode_observation
from ..engine.state import GameState
from ..env import core
from ..env import ring as ring_lib


@dataclass
class DualStepOutput:
    # The observation and mask after the turn; `dual_step_autoreset_ring`
    # leaves them None and returns those of the carried (reset) state.
    agent_obs: Optional[torch.Tensor]  # int32 [B, 297]
    agent_reward: torch.Tensor  # f32 [B]
    opp_obs: Optional[torch.Tensor]  # int32 [B, 297], the same board
    opp_reward: torch.Tensor  # f32 [B]
    done: torch.Tensor  # bool [B]
    action_mask: Optional[torch.Tensor]  # bool [B, 45], all False if done
    opp_action: torch.Tensor  # int64 [B]
    ended_on_agent: torch.Tensor  # bool [B]
    illegal_agent: torch.Tensor  # bool [B]
    turn_limit: torch.Tensor  # bool [B]


def _turn(state: GameState, agent_action, opponent_policy: Callable, rng_mode: str):
    """Both plies of a turn; returns (next_state, output without obs/mask).
    Each ply is an "engine.ply" span; the opponent's policy runs between."""
    # Phase 1: the agent moves; the opponent acts on its obs and mask.
    with trace.span("engine.ply"):
        state1, out_a = core.step(state, agent_action, rng_mode=rng_mode)
        done_a = out_a.terminated
        # Phase 2 counts only where the game goes on and it is the opponent's
        # turn (after an illegal agent action the turn ends as a -0.01 no-op).
        opp_phase = ~done_a & (state1.to_play == 1)
    opp_action = opponent_policy(out_a.obs, out_a.action_mask, state1)

    def sel(one_move, two_move):
        return torch.where(opp_phase.view((-1,) + (1,) * (one_move.dim() - 1)), two_move, one_move)

    with trace.span("engine.ply"):
        state2, fields_b = core.step_core(state1, opp_action, rng_mode=rng_mode)
        term_b = fields_b["terminated"]
        done = done_a | (opp_phase & term_b)
        next_state = GameState(**{k: sel(v, getattr(state2, k)) for k, v in state1.items()})
        agent_reward = torch.where(
            opp_phase,
            torch.where(term_b, fields_b["final_rewards"][:, 0], 0.0),
            out_a.reward,
        )
        opp_reward = torch.where(opp_phase, fields_b["reward"], out_a.final_rewards[:, 1])
        out = DualStepOutput(
            agent_obs=None,
            agent_reward=agent_reward.to(torch.float32),
            opp_obs=None,
            opp_reward=opp_reward.to(torch.float32),
            done=done,
            action_mask=None,
            opp_action=opp_action,
            ended_on_agent=done_a,
            illegal_agent=out_a.illegal_action,
            turn_limit=sel(out_a.turn_limit, fields_b["turn_limit"]),
        )
    return next_state, out


def dual_step(state: GameState, agent_action, opponent_policy: Callable, rng_mode: str = "fast"):
    """A complete turn for B games -> (next_state, DualStepOutput)."""
    next_state, out = _turn(state, agent_action, opponent_policy, rng_mode)
    # encode and legal_mask are per-game functions, so computing them on the
    # selected state equals selecting between the two plies' values.
    with trace.span("engine.ply"):
        obs = encode_observation(next_state)
        out.agent_obs = out.opp_obs = obs
        out.action_mask = rules.legal_mask(next_state) & ~out.done[:, None]
    return next_state, out


def dual_step_autoreset(state: GameState, agent_action, opponent_policy: Callable,
                        generator=None, rng_mode: str = "fast", fresh=None, mesh=None):
    """`dual_step` with a fresh game wherever one ends: a full-batch
    `core.reset(B, generator)`, or `fresh` (state, obs, mask) when the
    caller deals them.  With a `mesh` of dp > 1 the deal is the global
    batch's, of which this rank keeps its rows.

    Returns (carry, out, obs_next, mask_next, done): `out` keeps the
    terminal data for GAE; obs_next and mask_next feed the next policy call.
    """
    next_state, out = dual_step(state, agent_action, opponent_policy, rng_mode)
    with trace.span("engine.reset"):
        if fresh is None:
            B, dp = agent_action.shape[0], 1 if mesh is None else mesh.dp
            fresh = core.reset(B * dp, generator, state.to_play.device)
            if dp > 1:
                fresh = (fresh[0].map(mesh.rows), mesh.rows(fresh[1]), mesh.rows(fresh[2]))
        fresh_state, fresh_obs, fresh_mask = fresh
        done = out.done
        return (core.select(done, fresh_state, next_state), out,
                core.select(done, fresh_obs, out.agent_obs),
                core.select(done, fresh_mask, out.action_mask), done)


def dual_step_autoreset_ring(state: GameState, agent_action, opponent_policy: Callable,
                             ring: ring_lib.FreshGameRing, rng_mode: str = "fast", mesh=None):
    """`dual_step` with done games replaced from the fresh-game ring (the
    global take of `ring_lib.take` with a `mesh`).

    Returns (carry, out, obs_next, mask_next, done, ring); obs_next and
    mask_next are those of the carried state, fresh where done.
    """
    next_state, out = _turn(state, agent_action, opponent_policy, rng_mode)
    with trace.span("engine.reset"):
        fresh_state, _, ring = ring_lib.take(ring, out.done, mesh)
        carry = core.select(out.done, fresh_state, next_state)
        obs_next = encode_observation(carry)
        mask_next = rules.legal_mask(carry)
    return carry, out, obs_next, mask_next, out.done, ring

"""Dual-step self-play: one call advances a whole turn, the agent's ply
(player 0) and then the opponent's (player 1), for a batch of games.

Counterpart of `splendax/selfplay/dual.py`, with its reward contract:
  * the game ends on the agent's move -> the agent gets that step's reward,
    the opponent final_rewards[1];
  * the game ends on the opponent's move -> the agent gets final_rewards[0],
    the opponent that step's reward;
  * the turn completes and the game goes on -> both get 0.

`opponent_policy(obs, mask, state) -> action [B]` acts on the whole batch.

On the card in fast mode each ply, and the autoreset's selection, encode
and mask, is one launch of the ply's kernels (`ops/engine_ply`: the agent's
ply one step launch with its obs and mask, the opponent's one step launch
that holds the games it does not move, the observation and the reset one
observe launch each); the opponent's policy and the ring take run between
them.
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
from ..ops import engine_ply


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


def _agent_ply(state: GameState, action, mask, rng_mode: str = "fast"):
    """The agent's ply: `core.step`, with the next obs and mask."""
    return core.step(state, action, rng_mode=rng_mode, mask=mask)


def _opponent_ply(state1: GameState, opp_action, mask, done_a, reward_a, final_a, turn_limit_a,
                  rng_mode: str = "fast"):
    """The opponent's ply after the agent's outcome (`done_a`, `reward_a`,
    `final_a` [B, 2], `turn_limit_a`); `mask` is the agent ply's next mask.
    Returns (next_state, agent_reward, opp_reward, done, turn_limit)."""
    # Phase 2 counts only where the game goes on and it is the opponent's
    # turn (after an illegal agent action the turn ends as a -0.01 no-op).
    # There `mask` is legal_mask(state1); every other row is dropped.
    opp_phase = ~done_a & (state1.to_play == 1)

    def sel(one_move, two_move):
        return torch.where(opp_phase.view((-1,) + (1,) * (one_move.dim() - 1)), two_move, one_move)

    if engine_ply.takes(state1.to_play, rng_mode):  # the other rows keep their state
        next_state, fields_b, _, _ = engine_ply.step(state1, opp_action, mask, hold=~opp_phase)
    else:
        state2, fields_b = core.step_core(state1, opp_action, rng_mode=rng_mode, mask=mask)
        next_state = GameState(**{k: sel(v, getattr(state2, k)) for k, v in state1.items()})
    term_b = fields_b["terminated"]
    agent_reward = torch.where(
        opp_phase, torch.where(term_b, fields_b["final_rewards"][:, 0], 0.0), reward_a)
    opp_reward = torch.where(opp_phase, fields_b["reward"], final_a[:, 1])
    return (next_state, agent_reward.to(torch.float32), opp_reward.to(torch.float32),
            done_a | (opp_phase & term_b), sel(turn_limit_a, fields_b["turn_limit"]))


def _observe(state: GameState, done, rng_mode: str = "fast"):
    """The obs and the legal mask of each game, all False where `done`."""
    if engine_ply.takes(state.to_play, rng_mode):
        return engine_ply.observe(state, done=done, mask_off=True)[1:]
    return encode_observation(state), rules.legal_mask(state) & ~done[:, None]


def _reset(done, fresh: GameState, cur: GameState, rng_mode: str = "fast"):
    """The carried state, `fresh` where `done`, with its obs and mask."""
    if engine_ply.takes(cur.to_play, rng_mode):
        return engine_ply.observe(cur, fresh=fresh, done=done)
    carry = core.select(done, fresh, cur)
    return carry, encode_observation(carry), rules.legal_mask(carry)


def _turn(state: GameState, agent_action, opponent_policy: Callable, rng_mode: str, mask=None):
    """Both plies of a turn; returns (next_state, output without obs/mask).
    Each ply is an "engine.ply" span and one launch of the ply's kernel;
    the opponent's policy runs between.  `mask` may pass
    in the state's legal mask."""
    # Phase 1: the agent moves; the opponent acts on its obs and mask.
    with trace.span("engine.ply"):
        state1, out_a = _agent_ply(state, agent_action, mask, rng_mode=rng_mode)
    opp_action = opponent_policy(out_a.obs, out_a.action_mask, state1)

    with trace.span("engine.ply"):
        next_state, agent_reward, opp_reward, done, turn_limit = _opponent_ply(
            state1, opp_action, out_a.action_mask, out_a.terminated, out_a.reward,
            out_a.final_rewards, out_a.turn_limit, rng_mode=rng_mode)
        out = DualStepOutput(
            agent_obs=None,
            agent_reward=agent_reward,
            opp_obs=None,
            opp_reward=opp_reward,
            done=done,
            action_mask=None,
            opp_action=opp_action,
            ended_on_agent=out_a.terminated,
            illegal_agent=out_a.illegal_action,
            turn_limit=turn_limit,
        )
    return next_state, out


def dual_step(state: GameState, agent_action, opponent_policy: Callable, rng_mode: str = "fast",
              mask=None):
    """A complete turn for B games -> (next_state, DualStepOutput).  `mask`
    may pass in the state's legal mask."""
    next_state, out = _turn(state, agent_action, opponent_policy, rng_mode, mask)
    # encode and legal_mask are per-game functions, so computing them on the
    # selected state equals selecting between the two plies' values.
    with trace.span("engine.ply"):
        obs, out.action_mask = _observe(next_state, out.done, rng_mode=rng_mode)
        out.agent_obs = out.opp_obs = obs
    return next_state, out


def dual_step_autoreset(state: GameState, agent_action, opponent_policy: Callable,
                        generator=None, rng_mode: str = "fast", fresh=None, mesh=None, mask=None):
    """`dual_step` with a fresh game wherever one ends: a full-batch
    `core.reset(B, generator)`, or `fresh` (state, obs, mask) when the
    caller deals them.  With a `mesh` of dp > 1 the deal is the global
    batch's, of which this rank keeps its rows.  `mask` may pass in the
    state's legal mask.

    Returns (carry, out, obs_next, mask_next, done): `out` keeps the
    terminal data for GAE; obs_next and mask_next feed the next policy call.
    """
    next_state, out = dual_step(state, agent_action, opponent_policy, rng_mode, mask)
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
                             ring: ring_lib.FreshGameRing, rng_mode: str = "fast", mesh=None,
                             mask=None):
    """`dual_step` with done games replaced from the fresh-game ring (the
    global take of `ring_lib.take` with a `mesh`).  `mask` may pass in the
    state's legal mask.

    Returns (carry, out, obs_next, mask_next, done, ring); obs_next and
    mask_next are those of the carried state, fresh where done.  The ring
    take is kernel B; the selection, encode and mask one observe launch.
    """
    next_state, out = _turn(state, agent_action, opponent_policy, rng_mode, mask)
    with trace.span("engine.reset"):
        fresh_state, _, ring = ring_lib.take(ring, out.done, mesh)
        carry, obs_next, mask_next = _reset(out.done, fresh_state, next_state,
                                            rng_mode=rng_mode)
    return carry, out, obs_next, mask_next, out.done, ring

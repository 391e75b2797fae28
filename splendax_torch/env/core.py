"""Batched functional Splendor environment.

Counterpart of `splendax/env/core.py`: `step` maps (GameState [B],
action [B]) to (GameState [B], StepOutput) for all B games at once, and
`step_autoreset` replaces the games that end with a full batch of fresh
deals.

Edge cases, as in the JAX package:
  * no legal move -> a draw: reward 0, `draw=True`, game over with no
    winner and `to_play=0`;
  * an illegal (masked-off) action -> reward -0.01, state unchanged,
    `illegal_action=True`;
  * the terminal reward is from the point of view of the player who just
    moved: +1/-1/0, or -0.1 for a turn-limit draw;
  * `final_rewards` holds both players' rewards once the game ends.

On the card in fast mode `step_core` and `step` are one launch of the ply's
kernel (`ops/engine_ply`); `step_core_plain` and `step_plain` are the same
functions in plain PyTorch, the CPU's and parity mode's path, which the
kernel is held against.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..engine import rules
from ..engine.encode import encode_observation
from ..engine.rules import TOTAL_ACTIONS
from ..engine.state import GameState, initial_state
from ..ops import engine_ply


@dataclass
class StepOutput:
    obs: torch.Tensor  # int32 [B, 297], next observation (player-to-move POV)
    reward: torch.Tensor  # f32 [B], the just-moved player's reward
    terminated: torch.Tensor  # bool [B]
    action_mask: torch.Tensor  # bool [B, 45] for the next state (all False if terminal)
    to_play: torch.Tensor  # int32 [B]
    illegal_action: torch.Tensor  # bool [B]
    draw: torch.Tensor  # bool [B] (stalemate: no legal move)
    turn_limit: torch.Tensor  # bool [B]
    final_rewards: torch.Tensor  # f32 [B, 2], zeros until terminal


def reset(B: int, generator: torch.Generator, device="cuda"):
    """B fresh games -> (state, obs, mask)."""
    state = initial_state(B, generator, device)
    return state, encode_observation(state), rules.legal_mask(state)


def final_rewards_of(state: GameState) -> torch.Tensor:
    """f32 [B, 2] per-player terminal rewards; -0.1 each for a turn-limit
    draw, 0 for any other draw."""
    w = state.winner[:, None]
    draw_r = torch.where(state.turn_limit_reached, -0.1, 0.0).to(torch.float32)[:, None]
    players = torch.arange(2, device=w.device)[None]
    win = torch.where(players == w, 1.0, -1.0).to(torch.float32)
    return torch.where(w < 0, draw_r, win)


def step_core(state: GameState, action: torch.Tensor, rng_mode: str = "fast", mask=None):
    """The transition with its reward and flags, without the observation
    encode or the next mask.  Returns (next_state, fields), where `fields`
    are the StepOutput fields other than obs and action_mask."""
    if engine_ply.takes(state.to_play, rng_mode):
        return engine_ply.step(state, action, mask)[:2]
    return step_core_plain(state, action, rng_mode, mask)


def step_core_plain(state: GameState, action: torch.Tensor, rng_mode: str = "fast", mask=None):
    """`step_core` in plain PyTorch."""
    action = action.long().clamp(0, TOTAL_ACTIONS - 1)
    if mask is None:
        mask = rules.legal_mask(state)
    any_legal = mask.any(1)
    legal = mask.gather(1, action[:, None])[:, 0] & any_legal

    applied = rules.apply_action_plain(state, action, rng_mode=rng_mode)
    no_move = ~any_legal

    def pick(name, cur, new):
        out = torch.where(legal.view((-1,) + (1,) * (cur.dim() - 1)), new, cur)
        if name == "game_over":
            return out | no_move
        if name == "winner":
            return torch.where(no_move, -1, out).to(cur.dtype)
        if name == "to_play":
            return torch.where(no_move, 0, out).to(cur.dtype)
        return out

    next_state = GameState(
        **{name: pick(name, cur, getattr(applied, name)) for name, cur in state.items()}
    )

    terminated = rules.is_terminal(next_state)
    w = next_state.winner
    just_moved = (next_state.to_play - 1) % 2
    win_reward = torch.where(
        (w < 0) & next_state.turn_limit_reached,
        -0.1,
        torch.where(w < 0, 0.0, torch.where(w == just_moved, 1.0, -1.0)),
    )
    reward = torch.where(
        no_move,
        0.0,
        torch.where(legal, torch.where(terminated, win_reward, 0.0), -0.01),
    ).to(torch.float32)

    fields = dict(
        reward=reward,
        terminated=terminated,
        to_play=next_state.to_play,
        illegal_action=any_legal & ~legal,
        draw=no_move,
        turn_limit=terminated & next_state.turn_limit_reached,
        final_rewards=torch.where(terminated[:, None], final_rewards_of(next_state), 0.0),
    )
    return next_state, fields


def step(state: GameState, action: torch.Tensor, rng_mode: str = "fast", mask=None):
    """One transition for each of B games.  `mask` may pass in the state's
    legal mask when the caller has it."""
    if engine_ply.takes(state.to_play, rng_mode):
        next_state, fields, obs, next_mask = engine_ply.step(
            state, action, mask, with_obs=True, with_mask=True, mask_live=True)
        return next_state, StepOutput(obs=obs, action_mask=next_mask, **fields)
    return step_plain(state, action, rng_mode, mask)


def step_plain(state: GameState, action: torch.Tensor, rng_mode: str = "fast", mask=None):
    """`step` in plain PyTorch."""
    next_state, fields = step_core_plain(state, action, rng_mode=rng_mode, mask=mask)
    obs = encode_observation(next_state)
    next_mask = rules.legal_mask(next_state) & ~fields["terminated"][:, None]
    return next_state, StepOutput(obs=obs, action_mask=next_mask, **fields)


# The JAX package's vmapped names; `reset` and `step` are batched already.
reset_batch = reset
step_batch = step


def select(done: torch.Tensor, fresh, cur):
    """`fresh` where `done`, else `cur`, row by row: for a GameState field
    by field, else for one tensor."""
    if isinstance(cur, GameState):
        return GameState(**{k: select(done, getattr(fresh, k), c) for k, c in cur.items()})
    return torch.where(done.view((-1,) + (1,) * (cur.dim() - 1)), fresh, cur)


def step_autoreset(state: GameState, action: torch.Tensor, generator=None,
                   rng_mode: str = "fast", mask=None, fresh=None):
    """Batched step with a fresh game wherever one ends.

    The fresh games are a full-batch `reset(B, generator)`, or `fresh`
    (state, obs, mask) when the caller deals them.  Returns (carry, out,
    obs_next, mask_next): `out` keeps the terminal observation, reward and
    final rewards; the carried state, obs and mask are the fresh game's
    where the game ended.
    """
    next_state, out = step(state, action, rng_mode=rng_mode, mask=mask)
    if fresh is None:
        fresh = reset(action.shape[0], generator, state.to_play.device)
    fresh_state, fresh_obs, fresh_mask = fresh
    done = out.terminated
    return (select(done, fresh_state, next_state), out, select(done, fresh_obs, out.obs),
            select(done, fresh_mask, out.action_mask))

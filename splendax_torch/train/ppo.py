"""Masked-PPO self-play: the rollout half.

Counterpart of the rollout in `splendax/train/ppo.py` (`_rollout`): T
complete self-play turns for N games.  Each turn runs the agent forward and
a masked sample, the pooled opponents' greedy forward, the two engine plies,
and the fresh-game ring autoreset.  The agent and opponent forwards run the
fused actor-critic kernel; the ring take runs the ring-take kernel.

`rollout_turn` is one turn with its random inputs (the action noise, the
opponent resample and the ring) open to the caller, so a test can drive it
in lockstep with the JAX functions.  The learner half (GAE, the clipped
loss, the optimizer) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..engine.state import GameState
from ..env import core
from ..env import ring as ring_lib
from ..models import actor_critic as ac
from ..ops.fused_actor_critic import fused_masked_forward
from ..selfplay import dual
from ..selfplay import pool as pool_lib
from .config import PPOConfig


@dataclass
class TrainState:
    params: ac.ActorCritic
    pool: pool_lib.OpponentPool
    env_state: GameState  # [N]
    obs: torch.Tensor  # int32 [N, 297]
    mask: torch.Tensor  # bool [N, 45]
    opp_idx: torch.Tensor  # int64 [N]
    generator: torch.Generator
    update_idx: int = 0
    global_step: int = 0


@dataclass
class Rollout:
    obs: torch.Tensor  # int32 [T, N, 297]
    mask: torch.Tensor  # bool [T, N, 45]
    action: torch.Tensor  # int64 [T, N]
    logp: torch.Tensor  # f32 [T, N]
    value: torch.Tensor  # f32 [T, N]
    reward: torch.Tensor  # f32 [T, N]
    done: torch.Tensor  # bool [T, N]
    overflow: torch.Tensor  # int64 scalar: lanes the ring clamped (0 = exact)


@dataclass
class Turn:
    """One turn's carry and record."""

    env_state: GameState
    obs: torch.Tensor  # the next turn's obs
    mask: torch.Tensor  # the next turn's mask
    opp_idx: torch.Tensor
    ring: ring_lib.FreshGameRing
    pool: pool_lib.OpponentPool
    logits: torch.Tensor  # masked agent logits
    value: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    opp_action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


def _check_supported(cfg: PPOConfig) -> None:
    if not cfg.self_play:
        raise NotImplementedError("self_play=False (heuristic opponents) is not ported yet")
    if cfg.search_opponent:
        raise NotImplementedError("search_opponent=True (the league slot) is not ported yet")
    if cfg.reset_ring_mult <= 0:
        raise NotImplementedError("reset_ring_mult=0 (full-batch autoreset) is not ported")


def _sample_opponents(cfg: PPOConfig, pool, generator, n: int):
    return pool_lib.sample_opponent_idx(pool, n, generator, cfg.opponent_sampling)


def _opponent_policy(cfg: PPOConfig, pool, opp_idx):
    return pool_lib.pool_greedy_policy(pool, opp_idx)


def init_train_state(cfg: PPOConfig, params: ac.ActorCritic | None = None,
                     device="cuda") -> TrainState:
    """Fresh params (unless given), pool, games and opponents, all drawn from
    one generator seeded with `cfg.seed`."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    model = params if params is not None else ac.ActorCritic(cfg.hidden, gen, device)
    pool = pool_lib.init_pool(model, cfg.pool_size, cfg.p_current)
    env_state, obs, mask = core.reset(cfg.num_envs, gen, device)
    return TrainState(
        params=model, pool=pool, env_state=env_state, obs=obs, mask=mask,
        opp_idx=_sample_opponents(cfg, pool, gen, cfg.num_envs), generator=gen,
    )


def rollout_turn(cfg: PPOConfig, weights, pool, env_state, obs, mask, opp_idx, ring,
                 generator=None, noise=None, new_idx=None) -> Turn:
    """One complete self-play turn for every game.

    `weights` are the agent's fused-forward weights.  `noise` (Gumbel
    [N, 45]) and `new_idx` (the opponent slots for games that start anew)
    are drawn from `generator` unless given.
    """
    logits, value = fused_masked_forward(weights, obs, mask)
    action, logp = ac.sample_action(logits, mask, generator=generator, noise=noise)
    policy = _opponent_policy(cfg, pool, opp_idx)
    env_state, out, obs_next, mask_next, done, ring = dual.dual_step_autoreset_ring(
        env_state, action, policy, ring, cfg.rng_mode
    )
    if cfg.opponent_sampling == "pfsp":
        pool = pool_lib.record_outcomes(pool, opp_idx, done, out.agent_reward > 0.5)
    if new_idx is None:
        new_idx = _sample_opponents(cfg, pool, generator, obs.shape[0])
    # A game that starts anew faces a newly drawn opponent.
    opp_idx = torch.where(done, new_idx, opp_idx)
    return Turn(
        env_state=env_state, obs=obs_next, mask=mask_next, opp_idx=opp_idx, ring=ring,
        pool=pool, logits=logits, value=value, action=action, logp=logp,
        opp_action=out.opp_action, reward=out.agent_reward, done=done,
    )


def rollout(cfg: PPOConfig, ts: TrainState):
    """T = cfg.num_steps self-play turns -> (new TrainState, Rollout).

    The ring holds reset_ring_mult * N fresh games with a window of N rows,
    so the take is exact: at most N games end in one turn.
    """
    _check_supported(cfg)
    pool = pool_lib.set_current(ts.pool, ts.params)
    weights = pool.slot(pool.pool_size)  # the live params
    dev = ts.obs.device
    T, N = cfg.num_steps, ts.obs.shape[0]
    ring = ring_lib.make_ring(cfg.reset_ring_mult * N, ts.generator, dev, window=N)
    traj = Rollout(
        obs=torch.empty((T,) + tuple(ts.obs.shape), dtype=ts.obs.dtype, device=dev),
        mask=torch.empty((T,) + tuple(ts.mask.shape), dtype=torch.bool, device=dev),
        action=torch.empty((T, N), dtype=torch.int64, device=dev),
        logp=torch.empty((T, N), dtype=torch.float32, device=dev),
        value=torch.empty((T, N), dtype=torch.float32, device=dev),
        reward=torch.empty((T, N), dtype=torch.float32, device=dev),
        done=torch.empty((T, N), dtype=torch.bool, device=dev),
        overflow=ring.overflow,
    )
    env_state, obs, mask, opp_idx = ts.env_state, ts.obs, ts.mask, ts.opp_idx
    for t in range(T):
        traj.obs[t] = obs
        traj.mask[t] = mask
        turn = rollout_turn(cfg, weights, pool, env_state, obs, mask, opp_idx, ring,
                            generator=ts.generator)
        for name in ("action", "logp", "value", "reward", "done"):
            getattr(traj, name)[t] = getattr(turn, name)
        env_state, obs, mask, opp_idx = turn.env_state, turn.obs, turn.mask, turn.opp_idx
        ring, pool = turn.ring, turn.pool
    traj.overflow = ring.overflow
    ts = TrainState(
        params=ts.params, pool=pool, env_state=env_state, obs=obs, mask=mask,
        opp_idx=opp_idx, generator=ts.generator, update_idx=ts.update_idx,
        global_step=ts.global_step,
    )
    return ts, traj

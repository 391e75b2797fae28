"""Masked-PPO self-play trainer: the rollout and the learner.

Counterpart of `splendax/train/ppo.py`.  `update_step` is one PPO update:
T complete self-play turns for N games, the bootstrap value, GAE, the
advantage normalisation, `update_epochs x num_minibatches` clipped-PPO steps
with the target-KL early stop, and the snapshot push into the opponent pool.

Each turn runs the agent forward and a masked sample, the opponents' move
(the pool's greedy forward, a Gumbel search over the current snapshot for
the games of the league slot, or a heuristic when `self_play` is off), the
two engine plies, and the autoreset: from the fresh-game ring, or with
`reset_ring_mult=0` from a full batch of fresh deals.  Every forward that
needs no gradient (agent, opponents, bootstrap value) runs the fused
actor-critic kernel; the ring take runs the ring-take kernel.  The loss differentiates
the plain forward (`ActorCritic.forward`) under autograd, as the JAX package
differentiates its plain forward.  Those products are float32:
`torch.backends.cuda.matmul.allow_tf32` is left off (PyTorch's default), so
the ratio of the first minibatch differs from 1 only by the kernel's 1e-5.

`rollout_turn` is one turn with its random inputs (the action noise, the
opponent resample, and the ring or the fresh deals) open to the caller, and
`_ppo_epochs` takes its permutations the same way, so a test can drive both
in lockstep with the JAX functions.

The target-KL early stop is a `break` on the host: the minibatch whose
approx-KL passes `target_kl` still takes its step, the rest of that epoch is
not run, and the next epoch starts afresh.  The JAX package runs those
minibatches as no-ops; the params, both Adam moments, the step count and the
reported metrics come out the same.  It costs one host read of the KL per
minibatch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..engine.state import GameState
from ..env import core
from ..env import ring as ring_lib
from ..models import actor_critic as ac
from ..ops.fused_actor_critic import fused_masked_forward
from ..search.gumbel import gumbel_search_fn
from ..search.ismc import determinize
from ..selfplay import dual
from ..selfplay import opponents
from ..selfplay import pool as pool_lib
from . import optim
from .config import PPOConfig


@dataclass
class TrainState:
    params: ac.ActorCritic
    opt_state: optim.AdamState
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
    ring: ring_lib.FreshGameRing | None  # None with reset_ring_mult=0
    pool: pool_lib.OpponentPool
    logits: torch.Tensor  # masked agent logits
    value: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    opp_action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


def _check_supported(cfg: PPOConfig) -> None:
    if cfg.rng_mode not in ("fast", "parity"):
        raise ValueError(f"unknown rng_mode {cfg.rng_mode!r}")
    if cfg.dp != 0 or cfg.tp != 1:
        raise NotImplementedError(
            "dp/tp other than 0/1 wait for the torch.distributed slice of the port")


def _static_sentinel_rows(cfg: PPOConfig, n: int, device) -> torch.Tensor:
    """bool [n]: the rows the static league partition pins to the sentinel:
    rows 0, stride, 2 * stride, ..., `n_search_static` of them."""
    rows = torch.arange(n, device=device)
    k = cfg.search_stride
    return (rows % k == 0) & (rows < cfg.n_search_static * k)


def _sample_opponents(cfg: PPOConfig, pool, generator, n: int):
    """The opponent slot of each of n new episodes.  With
    `cfg.search_opponent` the sentinel `pool_size + 1`, one past CURRENT,
    marks "the current snapshot wrapped in a Gumbel search": drawn with
    probability `p_search`, or with `search_static` pinned to a strided set
    of rows.  `record_outcomes` matches the sentinel to no slot, so those
    episodes stay out of the PFSP counts."""
    idx = pool_lib.sample_opponent_idx(pool, n, generator, cfg.opponent_sampling)
    if not cfg.search_opponent:
        return idx
    if cfg.search_static:
        use_search = _static_sentinel_rows(cfg, n, idx.device)
    else:
        use_search = torch.rand(n, generator=generator, device=idx.device) < cfg.p_search
    return torch.where(use_search, pool.pool_size + 1, idx)


def _opponent_policy(cfg: PPOConfig, pool, opp_idx, generator=None, search_draws=None):
    """The opponents' move: each game's pool slot played greedily, or with
    `self_play` off the heuristic `cfg.train_opponent` for every game.

    With `cfg.search_opponent`, the games whose slot is the sentinel face
    the CURRENT snapshot improved by a Gumbel sequential-halving search
    (`greedy_final`: the slot is a sparring partner, so it acts by the mean
    values alone; `search_censored` runs it over determinizations of the
    mover's information set).  The search runs on the sentinel rows only:
    the static strided slice, or the rows the Bernoulli draw marked, which
    costs one host read of their number.  `search_draws` passes the
    search's random inputs (`gumbel.gumbel_search_fn`'s `draws`)."""
    if not cfg.self_play:
        return opponents.device_policy(cfg.train_opponent, generator)
    base = pool_lib.pool_greedy_policy(pool, opp_idx)
    if not cfg.search_opponent:
        return base
    search_fn = gumbel_search_fn(
        m=cfg.search_m, k0=cfg.search_k0, horizon=cfg.search_horizon, rng_mode=cfg.rng_mode,
        greedy_final=True, determinize_fn=determinize if cfg.search_censored else None)
    cur = pool.slot(pool.pool_size)

    if cfg.search_static:
        lim, k = cfg.n_search_static * cfg.search_stride, cfg.search_stride

        def policy(obs, mask, state):
            action = base(obs, mask, state)
            if lim == 0:
                return action
            action[:lim:k] = search_fn(
                cur, obs[:lim:k].contiguous(), mask[:lim:k].contiguous(),
                state.map(lambda x: x[:lim:k]), generator, draws=search_draws)
            return action

        return policy

    def policy(obs, mask, state):
        action = base(obs, mask, state)
        rows = torch.nonzero(opp_idx == pool.pool_size + 1)[:, 0]
        if rows.numel() > 0:
            action[rows] = search_fn(cur, obs[rows], mask[rows], state.map(lambda x: x[rows]),
                                     generator, draws=search_draws)
        return action

    return policy


def init_train_state(cfg: PPOConfig, params: ac.ActorCritic | None = None,
                     device="cuda") -> TrainState:
    """Fresh params (unless given), optimizer state, pool, games and
    opponents, all drawn from one generator seeded with `cfg.seed`."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    model = params if params is not None else ac.ActorCritic(cfg.hidden, gen, device)
    pool = pool_lib.init_pool(model, cfg.pool_size, cfg.p_current)
    env_state, obs, mask = core.reset(cfg.num_envs, gen, device)
    return TrainState(
        params=model, opt_state=optim.init(model.parameters()), pool=pool,
        env_state=env_state, obs=obs, mask=mask,
        opp_idx=_sample_opponents(cfg, pool, gen, cfg.num_envs), generator=gen,
    )


def rollout_turn(cfg: PPOConfig, weights, pool, env_state, obs, mask, opp_idx, ring,
                 generator=None, noise=None, new_idx=None, search_draws=None,
                 fresh=None) -> Turn:
    """One complete self-play turn for every game.

    `weights` are the agent's fused-forward weights.  `noise` (Gumbel
    [N, 45]) and `new_idx` (the opponent slots for games that start anew)
    are drawn from `generator` unless given, and so are the league slot's
    search inputs `search_draws`.  With `ring` None (`reset_ring_mult=0`)
    the games that end restart from a full batch of fresh deals, dealt from
    `generator` unless given as `fresh` (state, obs, mask).
    """
    logits, value = fused_masked_forward(weights, obs, mask)
    action, logp = ac.sample_action(logits, mask, generator=generator, noise=noise)
    policy = _opponent_policy(cfg, pool, opp_idx, generator, search_draws)
    if ring is None:
        env_state, out, obs_next, mask_next, done = dual.dual_step_autoreset(
            env_state, action, policy, generator, cfg.rng_mode, fresh=fresh)
    else:
        env_state, out, obs_next, mask_next, done, ring = dual.dual_step_autoreset_ring(
            env_state, action, policy, ring, cfg.rng_mode)
    # Per-slot outcome counts only where PFSP reads them; against a heuristic
    # the credit would go to pool slots that did not play.
    if cfg.opponent_sampling == "pfsp" and cfg.self_play:
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
    so the take is exact: at most N games end in one turn.  With
    reset_ring_mult=0 there is no ring: each turn deals a full batch of
    fresh games, and `overflow` stays 0.
    """
    _check_supported(cfg)
    pool = pool_lib.set_current(ts.pool, ts.params)
    weights = pool.slot(pool.pool_size)  # the live params
    dev = ts.obs.device
    T, N = cfg.num_steps, ts.obs.shape[0]
    ring = (ring_lib.make_ring(cfg.reset_ring_mult * N, ts.generator, dev, window=N)
            if cfg.reset_ring_mult > 0 else None)
    no_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    traj = Rollout(
        obs=torch.empty((T,) + tuple(ts.obs.shape), dtype=ts.obs.dtype, device=dev),
        mask=torch.empty((T,) + tuple(ts.mask.shape), dtype=torch.bool, device=dev),
        action=torch.empty((T, N), dtype=torch.int64, device=dev),
        logp=torch.empty((T, N), dtype=torch.float32, device=dev),
        value=torch.empty((T, N), dtype=torch.float32, device=dev),
        reward=torch.empty((T, N), dtype=torch.float32, device=dev),
        done=torch.empty((T, N), dtype=torch.bool, device=dev),
        overflow=no_overflow if ring is None else ring.overflow,
    )
    env_state, obs, mask, opp_idx = ts.env_state, ts.obs, ts.mask, ts.opp_idx
    if cfg.self_play and cfg.search_opponent and cfg.search_static:
        # A checkpoint of a Bernoulli run resumed under the static partition
        # may hold the sentinel on rows outside the static set, where no
        # search would run: pin the static rows to the sentinel and clamp
        # stray sentinels to CURRENT.  A no-op for states made under this
        # partition.
        opp_idx = torch.where(_static_sentinel_rows(cfg, N, dev), pool.pool_size + 1,
                              torch.clamp(opp_idx, max=pool.pool_size))
    for t in range(T):
        traj.obs[t] = obs
        traj.mask[t] = mask
        turn = rollout_turn(cfg, weights, pool, env_state, obs, mask, opp_idx, ring,
                            generator=ts.generator)
        for name in ("action", "logp", "value", "reward", "done"):
            getattr(traj, name)[t] = getattr(turn, name)
        env_state, obs, mask, opp_idx = turn.env_state, turn.obs, turn.mask, turn.opp_idx
        ring, pool = turn.ring, turn.pool
    traj.overflow = no_overflow if ring is None else ring.overflow
    ts = dataclasses.replace(ts, pool=pool, env_state=env_state, obs=obs, mask=mask,
                             opp_idx=opp_idx)
    return ts, traj


def _anneal(cfg: PPOConfig, update_idx: int):
    """The learning rate and entropy coefficient of update `update_idx`,
    computed in float32 as the JAX package computes them."""
    f32 = np.float32
    progress = f32(update_idx) / f32(max(1, cfg.num_updates - 1))
    lr = f32(cfg.lr) * (f32(1.0) - progress) if cfg.lr_anneal else f32(cfg.lr)
    ent = f32(cfg.ent_coef) + (f32(cfg.ent_coef_final) - f32(cfg.ent_coef)) * progress
    return float(lr), float(ent)


def _gae(cfg: PPOConfig, traj: Rollout, last_value: torch.Tensor):
    """Generalised advantage estimation, backwards over the T turns ->
    (advantages [T, N], returns [T, N])."""
    T = traj.reward.shape[0]
    adv = torch.empty_like(traj.value)
    nonterminal = 1.0 - traj.done.to(torch.float32)
    lastgaelam = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(T - 1, -1, -1):
        delta = traj.reward[t] + cfg.gamma * next_value * nonterminal[t] - traj.value[t]
        lastgaelam = delta + cfg.gamma * cfg.gae_lambda * nonterminal[t] * lastgaelam
        adv[t] = lastgaelam
        next_value = traj.value[t]
    return adv, adv + traj.value


def ppo_loss(cfg: PPOConfig, ent_coef_now, params: ac.ActorCritic, mo, mm, ma, mlp, mv,
             madv, mret):
    """The clipped PPO minibatch loss -> (loss, (pg_loss, v_loss, mean
    entropy, approx KL)): ratio clip, value clip, the entropy term (with
    the reference trainer's inverted sign behind
    `cfg.reference_entropy_quirk`), and the approx-KL that the early stop
    reads."""
    logits, value = params(mo)
    new_logp, ent = ac.log_prob_entropy(logits, mm, ma)
    ratio = torch.exp(new_logp - mlp)
    clip_adv = torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef) * madv
    pg_loss = -torch.minimum(ratio * madv, clip_adv).mean()
    v_clipped = mv + torch.clamp(value - mv, -cfg.vclip, cfg.vclip)
    v_loss = 0.5 * torch.maximum((value - mret) ** 2, (v_clipped - mret) ** 2).mean()
    mean_ent = ent.mean()
    ent_sign = 1.0 if cfg.reference_entropy_quirk else -1.0
    loss = pg_loss + cfg.vf_coef * v_loss + ent_coef_now * ent_sign * mean_ent
    approx_kl = (mlp - new_logp).mean()
    return loss, (pg_loss, v_loss, mean_ent, approx_kl)


METRIC_KEYS = ("pg_loss", "v_loss", "entropy", "approx_kl", "loss")


def _ppo_epochs(cfg: PPOConfig, ts: TrainState, batch, lr: float, ent_coef_now: float,
                perms=None):
    """`update_epochs` passes over the batch in minibatches, each a clipped
    Adam step in place on `ts.params`, with the target-KL early stop.

    `batch` is (obs, mask, action, logp, value, adv, returns), each [B, ...].
    `perms` (one int64 permutation of B per epoch) is drawn from
    `ts.generator` unless given.  Returns (ts, the last taken step's
    metrics as device scalars)."""
    B = batch[0].shape[0]
    mb = min(cfg.minibatch_size, B)
    n_mb = B // mb
    dev = batch[0].device
    model = ts.params
    params = list(model.parameters())
    metrics = {k: torch.zeros((), device=dev) for k in METRIC_KEYS}
    for epoch in range(cfg.update_epochs):
        perm = (torch.randperm(B, generator=ts.generator, device=dev) if perms is None
                else perms[epoch])
        for idxs in perm[: n_mb * mb].reshape(n_mb, mb):
            loss, aux = ppo_loss(cfg, ent_coef_now, model, *(x[idxs] for x in batch))
            grads = torch.autograd.grad(loss, params)
            optim.step(params, grads, ts.opt_state, lr)
            metrics = dict(zip(METRIC_KEYS, (*(a.detach() for a in aux), loss.detach())))
            # The one host read of a minibatch; the step above is kept.
            if cfg.target_kl > 0 and metrics["approx_kl"].item() > cfg.target_kl:
                break
    return ts, metrics


def update_step(cfg: PPOConfig, ts: TrainState):
    """One full PPO update: rollout, GAE, epochs and pool maintenance ->
    (new TrainState, metrics dict of device scalars)."""
    lr, ent_coef_now = _anneal(cfg, ts.update_idx)

    ts, traj = rollout(cfg, ts)
    with torch.no_grad():
        # The CURRENT slot still holds the params the rollout ran.
        _, last_value = fused_masked_forward(ts.pool.slot(ts.pool.pool_size), ts.obs, ts.mask)
        adv, returns = _gae(cfg, traj, last_value)
        b_adv = adv.reshape(-1)
        # The population standard deviation, as jnp.std gives it.
        b_adv = (b_adv - b_adv.mean()) / (b_adv.std(correction=0) + 1e-8)
        batch = tuple(x.reshape((-1,) + tuple(x.shape[2:])) for x in (
            traj.obs, traj.mask, traj.action, traj.logp, traj.value)) + (
            b_adv, returns.reshape(-1))
    ts, metrics = _ppo_epochs(cfg, ts, batch, lr, ent_coef_now)

    pool = ts.pool
    if cfg.self_play and (ts.update_idx + 1) % max(1, cfg.snapshot_every_updates) == 0:
        pool = pool_lib.push_snapshot(pool, ts.params)

    dev = traj.reward.device
    ep_done = traj.done.sum()
    ep_won = ((traj.reward > 0.5) & traj.done).sum()
    metrics = dict(
        metrics,
        lr=torch.tensor(lr, device=dev),
        ent_coef=torch.tensor(ent_coef_now, device=dev),
        episodes=ep_done,
        rollout_win_rate=ep_won / torch.clamp(ep_done, min=1),
        mean_reward=traj.reward.mean(),
    )
    ts = dataclasses.replace(ts, pool=pool, update_idx=ts.update_idx + 1,
                             global_step=ts.global_step + cfg.num_envs * cfg.num_steps)
    return ts, metrics

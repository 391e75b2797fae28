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

On a dp x tp mesh (`parallel.mesh`; `TrainState.mesh`) each rank holds its
rows of the games and its tp shards of the params, and runs the same code:
  * every draw keeps its global shape, from a generator every rank holds in
    the same state, and each rank keeps its rows: the action noise, the
    opponent resample (with the league slot's Bernoulli draw and static
    rows), the league search's inputs, the heuristics' tie-breaks, the
    fresh deals and the epochs' permutations;
  * the ring is whole on every rank and its take counts the done games of
    the ranks before (`env.ring.take`); the PFSP counts are summed over dp;
  * the rollout's forwards run kernel A on whole weights, gathered over tp
    once a rollout (`models.actor_critic.kernel_weights`), the learner's
    forward and backward on the shards;
  * the advantages are normalised with the global mean and population std
    (two all-reduces), each global minibatch takes this rank's rows of a
    permutation of the global batch, its loss is this rank's sum over the
    global minibatch size, and the gradients are summed over dp;
  * the metrics are summed over dp from an all-gather over every rank, so
    the KL stop is decided on the same bits everywhere.
With dp = tp = 1 (or no mesh) all of this is the single-process code.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..engine.state import GameState
from ..env import core
from ..env import ring as ring_lib
from ..models import actor_critic as ac
from ..ops.fused_actor_critic import ACT_DIM, fused_masked_forward, fused_value_forward
from ..parallel import collectives
from ..parallel import mesh as mesh_lib
from ..search import gumbel
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
    mesh: mesh_lib.Mesh | None = None  # None: one process, every field whole


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


def _rows_of(mesh):
    """This rank's rows of a tensor in the global batch shape."""
    return (lambda x: x) if mesh is None else mesh.rows


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


def _opponent_policy(cfg: PPOConfig, pool, opp_idx, generator=None, search_draws=None,
                     mesh=None):
    """The opponents' move: each game's pool slot played greedily, or with
    `self_play` off the heuristic `cfg.train_opponent` for every game.

    With `cfg.search_opponent`, the games whose slot is the sentinel face
    the CURRENT snapshot improved by a Gumbel sequential-halving search
    (`greedy_final`: the slot is a sparring partner, so it acts by the mean
    values alone; `search_censored` runs it over determinizations of the
    mover's information set).  The search runs on the sentinel rows only:
    the static strided slice, or the rows the Bernoulli draw marked, which
    costs one host read of their number.  `search_draws` passes the
    search's random inputs (`gumbel.gumbel_search_fn`'s `draws`).

    With a `mesh` of dp > 1 the rows are this rank's: the heuristics and
    the search draw for the global batch and keep this rank's rows (for
    the Bernoulli slot one all-reduce of the per-rank sentinel counts
    tells which of the global search's games are this rank's)."""
    if not cfg.self_play:
        return opponents.device_policy(cfg.train_opponent, generator, mesh)
    base = pool_lib.pool_greedy_policy(pool, opp_idx)
    if not cfg.search_opponent:
        return base
    search_fn = gumbel_search_fn(
        m=cfg.search_m, k0=cfg.search_k0, horizon=cfg.search_horizon, rng_mode=cfg.rng_mode,
        greedy_final=True, determinize_fn=determinize if cfg.search_censored else None)
    cur = pool.slot(pool.pool_size)
    dp = 1 if mesh is None else mesh.dp
    m, k0 = cfg.search_m, cfg.search_k0

    def global_draws(n_games, lo, hi, device):
        """Games [lo, hi) of the global search's inputs over n_games."""
        draws = gumbel.draw_inputs(n_games, m, k0, cfg.search_horizon, generator, device,
                                   censored=cfg.search_censored)
        return gumbel.draw_rows(draws, lo, hi, m, k0)

    if cfg.search_static:
        S, k = cfg.n_search_static, cfg.search_stride

        def policy(obs, mask, state):
            action = base(obs, mask, state)
            if S == 0:
                return action
            # This rank's rows are [r0, r0 + B) of the global batch; its
            # sentinel games are j0..j1-1 of the global S, at rows j * k.
            B = obs.shape[0]
            r0 = 0 if mesh is None else mesh.dp_rank * B
            j0, j1 = -(-r0 // k), min(S, -(-(r0 + B) // k))
            draws = search_draws
            if draws is None and dp > 1:
                draws = global_draws(S, j0, j1, obs.device)
            if j1 > j0:
                sl = slice(j0 * k - r0, (j1 - 1) * k - r0 + 1, k)
                action[sl] = search_fn(
                    cur, obs[sl].contiguous(), mask[sl].contiguous(),
                    state.map(lambda x: x[sl]), generator, draws=draws)
            return action

        return policy

    def policy(obs, mask, state):
        action = base(obs, mask, state)
        rows = trace.sync("ppo.league_rows",
                          lambda: torch.nonzero(opp_idx == pool.pool_size + 1)[:, 0])
        c = rows.numel()
        draws = search_draws
        if draws is None and dp > 1:
            counts = torch.zeros(dp, dtype=torch.int64, device=obs.device)
            counts[mesh.dp_rank] = c
            counts = trace.sync("ppo.dp_counts",
                                collectives.all_reduce(counts, mesh.dp_group).tolist)
            j0 = sum(counts[:mesh.dp_rank])
            if sum(counts) > 0:
                draws = global_draws(sum(counts), j0, j0 + c, obs.device)
        if c > 0:
            action[rows] = search_fn(cur, obs[rows], mask[rows], state.map(lambda x: x[rows]),
                                     generator, draws=draws)
        return action

    return policy


def init_train_state(cfg: PPOConfig, params: ac.ActorCritic | None = None,
                     device="cuda") -> TrainState:
    """Fresh params (unless given whole), optimizer state, pool, games and
    opponents, all drawn from one generator seeded with `cfg.seed`.

    On the mesh that `cfg.dp`/`cfg.tp` ask for (`mesh_lib.mesh_from_cfg`:
    every multi-process run has one) every rank draws the whole state and
    keeps its shard of it."""
    _check_supported(cfg)
    device = resolve_device(device)
    mesh = mesh_lib.mesh_from_cfg(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    model = params if params is not None else ac.ActorCritic(cfg.hidden, gen, device)
    pool = pool_lib.init_pool(model, cfg.pool_size, cfg.p_current)
    env_state, obs, mask = core.reset(cfg.num_envs, gen, device)
    ts = TrainState(
        params=model, opt_state=optim.init(model.parameters()), pool=pool,
        env_state=env_state, obs=obs, mask=mask,
        opp_idx=_sample_opponents(cfg, pool, gen, cfg.num_envs), generator=gen,
    )
    return ts if mesh is None else mesh_lib.shard_train_state(ts, mesh)


def rollout_turn(cfg: PPOConfig, weights, pool, env_state, obs, mask, opp_idx, ring,
                 generator=None, noise=None, new_idx=None, search_draws=None,
                 fresh=None, mesh=None) -> Turn:
    """One complete self-play turn for every game.

    `weights` are the agent's fused-forward weights.  `noise` (Gumbel
    [N, 45]) and `new_idx` (the opponent slots for games that start anew)
    are drawn from `generator` unless given, and so are the league slot's
    search inputs `search_draws`.  With `ring` None (`reset_ring_mult=0`)
    the games that end restart from a full batch of fresh deals, dealt from
    `generator` unless given as `fresh` (state, obs, mask).

    With a `mesh` the games are this rank's rows of the global batch, and
    every draw is the global one's rows (module docstring); given inputs
    (`noise`, `new_idx`, `search_draws`, `fresh`) are this rank's.
    """
    rows = _rows_of(mesh)
    n = obs.shape[0] * (1 if mesh is None else mesh.dp)  # the global batch
    with trace.span("agent"):
        logits, value = fused_masked_forward(weights, obs, mask)
        if noise is None:
            noise = rows(ac.gumbel_noise((n, ACT_DIM), generator, obs.device))
        action, logp = ac.sample_action(logits, mask, generator=generator, noise=noise)
    policy = _opponent_policy(cfg, pool, opp_idx, generator, search_draws, mesh)
    if ring is None:
        env_state, out, obs_next, mask_next, done = dual.dual_step_autoreset(
            env_state, action, policy, generator, cfg.rng_mode, fresh=fresh, mesh=mesh, mask=mask)
    else:
        env_state, out, obs_next, mask_next, done, ring = dual.dual_step_autoreset_ring(
            env_state, action, policy, ring, cfg.rng_mode, mesh=mesh, mask=mask)
    # Per-slot outcome counts only where PFSP reads them; against a heuristic
    # the credit would go to pool slots that did not play.
    if cfg.opponent_sampling == "pfsp" and cfg.self_play:
        pool = pool_lib.record_outcomes(pool, opp_idx, done, out.agent_reward > 0.5,
                                        group=None if mesh is None else mesh.dp_group)
    if new_idx is None:
        new_idx = rows(_sample_opponents(cfg, pool, generator, n))
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
    fresh games, and `overflow` stays 0.  On a mesh, N is the global batch
    and the Rollout holds this rank's rows; the CURRENT slot takes the
    params gathered whole over tp.
    """
    _check_supported(cfg)
    mesh = ts.mesh
    pool = pool_lib.set_current(ts.pool, ts.params)
    weights = pool.slot(pool.pool_size)  # the live params
    dev = ts.obs.device
    T, N = cfg.num_steps, ts.obs.shape[0]
    n = N * (1 if mesh is None else mesh.dp)
    ring = (ring_lib.make_ring(cfg.reset_ring_mult * n, ts.generator, dev, window=n)
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
        opp_idx = torch.where(_rows_of(mesh)(_static_sentinel_rows(cfg, n, dev)),
                              pool.pool_size + 1, torch.clamp(opp_idx, max=pool.pool_size))
    for t in range(T):
        traj.obs[t] = obs
        traj.mask[t] = mask
        turn = rollout_turn(cfg, weights, pool, env_state, obs, mask, opp_idx, ring,
                            generator=ts.generator, mesh=mesh)
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
             madv, mret, denom=None):
    """The clipped PPO minibatch loss -> (loss, (pg_loss, v_loss, mean
    entropy, approx KL)): ratio clip, value clip, the entropy term (with
    the reference trainer's inverted sign behind
    `cfg.reference_entropy_quirk`), and the approx-KL that the early stop
    reads.  Each mean is over the rows given, or with `denom` their sum
    over `denom` (this rank's share of a minibatch of `denom` rows)."""
    mean = (lambda x: x.mean()) if denom is None else (lambda x: x.sum() / denom)
    logits, value = params(mo)
    new_logp, ent = ac.log_prob_entropy(logits, mm, ma)
    ratio = torch.exp(new_logp - mlp)
    clip_adv = torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef) * madv
    pg_loss = -mean(torch.minimum(ratio * madv, clip_adv))
    v_clipped = mv + torch.clamp(value - mv, -cfg.vclip, cfg.vclip)
    v_loss = 0.5 * mean(torch.maximum((value - mret) ** 2, (v_clipped - mret) ** 2))
    mean_ent = mean(ent)
    ent_sign = 1.0 if cfg.reference_entropy_quirk else -1.0
    loss = pg_loss + cfg.vf_coef * v_loss + ent_coef_now * ent_sign * mean_ent
    approx_kl = mean(mlp - new_logp)
    return loss, (pg_loss, v_loss, mean_ent, approx_kl)


METRIC_KEYS = ("pg_loss", "v_loss", "entropy", "approx_kl", "loss")


def _ppo_epochs(cfg: PPOConfig, ts: TrainState, batch, lr: float, ent_coef_now: float,
                perms=None):
    """`update_epochs` passes over the batch in minibatches, each a clipped
    Adam step in place on `ts.params`, with the target-KL early stop.

    `batch` is (obs, mask, action, logp, value, adv, returns), each [B, ...].
    `perms` (one int64 permutation of B per epoch) is drawn from
    `ts.generator` unless given.  Returns (ts, the last taken step's
    metrics as device scalars).

    On a mesh of dp > 1, `batch` is this rank's rows of the global
    [T, N] batch flattened turn-major ([T, N / dp] here), B and `perms`
    are the global batch's, and each minibatch takes this rank's rows of
    it (module docstring)."""
    mesh = ts.mesh
    dp = 1 if mesh is None else mesh.dp
    B = batch[0].shape[0] * dp
    mb = min(cfg.minibatch_size, B)
    n_mb = B // mb
    dev = batch[0].device
    model = ts.params
    params = list(model.parameters())
    tp_group = None if mesh is None else mesh.tp_group
    sharded = None if tp_group is None else [d is not None for d in model.shard_dims]
    metrics = {k: torch.zeros((), device=dev) for k in METRIC_KEYS}
    for epoch in range(cfg.update_epochs):
        perm = (torch.randperm(B, generator=ts.generator, device=dev) if perms is None
                else perms[epoch])
        for idxs in perm[: n_mb * mb].reshape(n_mb, mb):
            with trace.span("epochs.step"):
                if dp > 1:
                    idxs = _local_rows(idxs, ts.obs.shape[0], mesh)
                loss, aux = ppo_loss(cfg, ent_coef_now, model, *(x[idxs] for x in batch),
                                     denom=mb if dp > 1 else None)
                grads = torch.autograd.grad(loss, params)
                if dp > 1:
                    grads = _sum_over(grads, mesh.dp_group)
                optim.step(params, grads, ts.opt_state, lr, tp_group=tp_group, sharded=sharded)
                metrics = dict(zip(METRIC_KEYS, (*(a.detach() for a in aux), loss.detach())))
                if mesh is not None and mesh.size > 1:
                    metrics = dict(zip(METRIC_KEYS, _mesh_sum(
                        torch.stack(list(metrics.values())), mesh)))
                # The one host read of a minibatch; the step above is kept.
                stop = cfg.target_kl > 0 and trace.sync(
                    "ppo.kl", metrics["approx_kl"].item) > cfg.target_kl
            if stop:
                break
    return ts, metrics


def _local_rows(idxs: torch.Tensor, n_local: int, mesh) -> torch.Tensor:
    """This rank's rows of global batch rows `idxs` (of a turn-major
    [T, n_local * dp] batch), as indices into its [T, n_local] rows."""
    n = n_local * mesh.dp
    lo = mesh.dp_rank * n_local
    t, col = idxs // n, idxs % n
    keep = (col >= lo) & (col < lo + n_local)
    return (t * n_local + col - lo)[keep]


def _sum_over(tensors, group) -> list:
    """The tensors summed over `group`: one all-reduce of them packed."""
    flat = collectives.all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [x.view_as(t) for x, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _mesh_sum(vec: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over dp of each dp index's `vec` (the tp ranks of a dp index
    hold the same): gathered from every rank and added in rank order, so
    the result has the same bits on every rank."""
    return collectives.all_gather(vec, mesh.world_group)[:: mesh.tp].sum(0)


def _normalise(adv: torch.Tensor, mesh) -> torch.Tensor:
    """(adv - mean) / (population std + 1e-8) over the global batch: with
    dp > 1 the mean, then the squared deviations, summed over dp."""
    if mesh is None or mesh.dp == 1:
        # The population standard deviation, as jnp.std gives it.
        return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    n = adv.numel() * mesh.dp
    mean = collectives.all_reduce(adv.sum().reshape(1), mesh.dp_group)[0] / n
    sq = collectives.all_reduce(((adv - mean) ** 2).sum().reshape(1), mesh.dp_group)[0]
    return (adv - mean) / (torch.sqrt(sq / n) + 1e-8)


def update_step(cfg: PPOConfig, ts: TrainState):
    """One full PPO update: rollout, GAE, epochs and pool maintenance ->
    (new TrainState, metrics dict of device scalars)."""
    with trace.span("update"):
        lr, ent_coef_now = _anneal(cfg, ts.update_idx)

        with trace.span("rollout"):
            ts, traj = rollout(cfg, ts)
        with torch.no_grad(), trace.span("gae"):
            # The CURRENT slot still holds the params the rollout ran.
            last_value = fused_value_forward(ts.pool.slot(ts.pool.pool_size), ts.obs)
            adv, returns = _gae(cfg, traj, last_value)
            b_adv = _normalise(adv.reshape(-1), ts.mesh)
            batch = tuple(x.reshape((-1,) + tuple(x.shape[2:])) for x in (
                traj.obs, traj.mask, traj.action, traj.logp, traj.value)) + (
                b_adv, returns.reshape(-1))
        with trace.span("epochs"):
            ts, metrics = _ppo_epochs(cfg, ts, batch, lr, ent_coef_now)

        pool = ts.pool
        if cfg.self_play and (ts.update_idx + 1) % max(1, cfg.snapshot_every_updates) == 0:
            with trace.span("pool.push"):
                pool = pool_lib.push_snapshot(pool, ts.params)

        dev = traj.reward.device
        ep_done = traj.done.sum()
        ep_won = ((traj.reward > 0.5) & traj.done).sum()
        mean_reward = traj.reward.mean()
        if ts.mesh is not None and ts.mesh.dp > 1:  # over the global batch
            tot = collectives.all_reduce(torch.stack([ep_done.double(), ep_won.double(),
                                                      traj.reward.double().sum()]),
                                         ts.mesh.dp_group)
            ep_done, ep_won = tot[0].long(), tot[1].long()
            mean_reward = (tot[2] / (traj.reward.numel() * ts.mesh.dp)).float()
        # Two pageable host-to-device copies, which block.
        lr_t, ent_t = trace.sync("ppo.scalars", lambda: (
            torch.tensor(lr, device=dev), torch.tensor(ent_coef_now, device=dev)))
        metrics = dict(
            metrics,
            lr=lr_t,
            ent_coef=ent_t,
            episodes=ep_done,
            rollout_win_rate=ep_won / torch.clamp(ep_done, min=1),
            mean_reward=mean_reward,
        )
        ts = dataclasses.replace(ts, pool=pool, update_idx=ts.update_idx + 1,
                                 global_step=ts.global_step + cfg.num_envs * cfg.num_steps)
        return ts, metrics

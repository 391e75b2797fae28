"""Opponent pool: stacked parameter snapshots.

Counterpart of `splendax/selfplay/pool.py`.  The pool holds `pool_size + 1`
parameter slots, each weight stacked on a leading axis in the fused
forward's layout (`models.actor_critic.kernel_weights`):

  * slots 0..pool_size-1: a FIFO ring of frozen snapshots;
  * slot pool_size (the CURRENT slot): the live params, written at the start
    of every rollout, so facing the current policy is sampling that index.

Each game has an int opponent slot.  The JAX package computes the logits
under all slots and selects each game's row; here the games are grouped by
slot and the fused kernel runs once per slot that has games, on those rows
only.  Both give the same greedy action.

`set_current` and `push_snapshot` write the slot in place and return the
pool with its counters updated.  On a dp x tp mesh every rank holds every
slot whole: writing a slot from a tp-sharded model gathers its weights
(`kernel_weights`), and the PFSP counts are summed over dp as they are
recorded, so `sample_opponent_idx` reads the global ones.  The per-slot
launches and their host sync in `pool_greedy_policy` stay per rank.

Each slot's weights are a `PreparedWeights` handle over views of the stack
(`slot(i)`), so a slot's kernel A preparation is made once per weight
version, not once a forward.  The views share the stack's version
counters: a write to one slot moves every slot's counters.  `_write_slot`
therefore records, for every other slot whose preparation was current just
before its write, the counters as they are after it; a slot that was stale
stays stale, so no write hides another.  The handles are built with the
pool, kept by `replace`, built anew when `replace` is given a new stack,
and copied with their preparations by `deepcopy`.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass

import torch

from .. import trace
from ..models.actor_critic import ActorCritic, kernel_weights
from ..ops.fused_actor_critic import PreparedWeights, fused_masked_forward, read_versions
from ..parallel import collectives
from .opponents import first_legal


@dataclass
class OpponentPool:
    stack: list  # 12 tensors [pool_size + 1, ...] in kernel layout
    n_snapshots: int  # snapshots ever pushed
    p_current: float
    # Per-slot outcome counts from the agent's point of view; they drive
    # PFSP sampling and reset when a slot is overwritten.
    wins: torch.Tensor  # f32 [pool_size + 1]
    games: torch.Tensor  # f32 [pool_size + 1]
    # A PreparedWeights a slot over views of `stack`; built from it when None.
    slots: list = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.slots is None:
            self.slots = [PreparedWeights([w[i] for w in self.stack])
                          for i in range(self.pool_size + 1)]

    @property
    def pool_size(self) -> int:
        return self.stack[0].shape[0] - 1

    @property
    def filled(self) -> int:
        return min(self.n_snapshots, self.pool_size)

    @property
    def win_rates(self) -> torch.Tensor:
        """Agent win rate per slot; 0.5 below 8 games of evidence."""
        return torch.where(self.games >= 8, self.wins / torch.clamp(self.games, min=1.0), 0.5)

    def slot(self, i: int) -> PreparedWeights:
        """The 12 weights of slot i, views of the stack, as the slot's
        handle."""
        return self.slots[i]

    def replace(self, **kw) -> "OpponentPool":
        """The pool with fields replaced; the slots' handles carry over
        unless `stack` is replaced, which builds them anew."""
        if "stack" in kw:
            kw.setdefault("slots", None)
        return dataclasses.replace(self, **kw)

    def __deepcopy__(self, memo):
        """A copy of the stack and counts, its handles over the copy's views,
        each with a copy of its slot's preparation where that was current."""
        out = OpponentPool(copy.deepcopy(self.stack, memo), self.n_snapshots, self.p_current,
                           copy.deepcopy(self.wins, memo), copy.deepcopy(self.games, memo))
        for mine, theirs in zip(out.slots, self.slots):
            mine.take_preparation(theirs, memo)
        return out


def init_pool(model: ActorCritic, pool_size: int, p_current: float = 0.25) -> OpponentPool:
    weights = kernel_weights(model)
    dev = weights[0].device
    return OpponentPool(
        stack=[w[None].repeat((pool_size + 1,) + (1,) * w.dim()) for w in weights],
        n_snapshots=0,
        p_current=float(p_current),
        wins=torch.zeros(pool_size + 1, device=dev),
        games=torch.zeros(pool_size + 1, device=dev),
    )


def _write_slot(pool: OpponentPool, slot: int, model: ActorCritic) -> OpponentPool:
    """Write `model`'s weights into `slot`: its handle is stale from now on;
    every other slot's keeps its preparation if it was current before."""
    weights = kernel_weights(model)  # on a tp mesh a collective, before any write
    before = [read_versions(h) for h in pool.slots]
    for s, w in zip(pool.stack, weights):
        s[slot].copy_(w)
    for i, h in enumerate(pool.slots):
        if i != slot:
            h.carry(before[i])
    wins, games = pool.wins.clone(), pool.games.clone()

    def reset_counts():  # a Python number written into a device tensor blocks
        wins[slot] = 0.0
        games[slot] = 0.0

    trace.sync("pool.slot_reset", reset_counts)
    return pool.replace(wins=wins, games=games)


def set_current(pool: OpponentPool, model: ActorCritic) -> OpponentPool:
    """Write the live params into the CURRENT slot and reset its counts:
    each rollout faces a new current policy."""
    return _write_slot(pool, pool.pool_size, model)


def push_snapshot(pool: OpponentPool, model: ActorCritic) -> OpponentPool:
    """FIFO append: overwrite the oldest frozen slot and reset its counts."""
    pool = _write_slot(pool, pool.n_snapshots % pool.pool_size, model)
    return pool.replace(n_snapshots=pool.n_snapshots + 1)


def record_outcomes(pool: OpponentPool, opp_idx, done, won, group=None) -> OpponentPool:
    """Add finished episodes to the per-slot counts (`opp_idx` int [B],
    `done`/`won` bool [B]).  An index past CURRENT (the league slot's
    sentinel) matches no slot, so those episodes add nothing.  With a dp
    `group`, the rows are this rank's and the counts added are summed over
    the group, so every rank holds the global counts."""
    oh = (torch.arange(pool.pool_size + 1, device=opp_idx.device)[None] == opp_idx[:, None])
    oh = oh.to(torch.float32)
    d = done.to(torch.float32)[:, None]
    w = (done & won).to(torch.float32)[:, None]
    add = collectives.all_reduce(torch.stack([(oh * w).sum(0), (oh * d).sum(0)]), group)
    return pool.replace(wins=pool.wins + add[0], games=pool.games + add[1])


def sample_opponent_idx(pool: OpponentPool, n: int, generator=None, mode: str = "uniform"):
    """int64 [n] opponent slots: CURRENT with probability p_current (always,
    while no snapshot is in the pool), else a frozen snapshot, drawn
    uniformly (mode="uniform") or with weight (1 - win rate)^2 + 0.05
    (mode="pfsp", prioritized fictitious self-play)."""
    dev = pool.wins.device
    filled = pool.filled
    use_current = torch.rand(n, generator=generator, device=dev) < pool.p_current
    if filled == 0:
        use_current = torch.ones_like(use_current)
    if mode == "uniform":
        u = torch.rand(n, generator=generator, device=dev)
        frozen = torch.clamp((u * max(filled, 1)).long(), max=max(filled, 1) - 1)
    elif mode == "pfsp":
        in_pool = torch.arange(pool.pool_size + 1, device=dev) < filled
        hard = (1.0 - pool.win_rates) ** 2 + 0.05
        logits = torch.where(in_pool, torch.log(hard), -math.inf)
        if filled == 0:
            logits = torch.zeros_like(logits)
        u = torch.rand((n, logits.shape[0]), generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
        frozen = torch.argmax(logits[None] + gumbel, dim=-1)
    else:
        raise ValueError(f"unknown opponent sampling mode {mode!r}")
    return torch.where(use_current, pool.pool_size, frozen)


def pool_greedy_policy(pool: OpponentPool, opp_idx: torch.Tensor):
    """Opponent policy for `dual_step`: the greedy action of each game's
    pool slot, `policy(obs, mask, state) -> action int64 [B]`.

    A game whose slot lies past CURRENT (the league slot's sentinel,
    `train/ppo._sample_opponents`) matches no slot: no kernel runs on its
    row and it takes the first legal action, as the all-zero logits of the
    JAX package's unmatched one-hot give; the league slot's search then
    overwrites it."""

    def policy(obs, mask, state):
        with trace.span("pool"):
            order = torch.argsort(opp_idx, stable=True)
            # A host sync a turn: the per-slot row counts decide which kernel
            # launches to make and on how many rows.
            counts = trace.sync("pool.counts", lambda: torch.bincount(
                opp_idx, minlength=pool.pool_size + 1).tolist())
            action = torch.empty(obs.shape[0], dtype=torch.int64, device=obs.device)
            start = 0
            for s, c in enumerate(counts[: pool.pool_size + 1]):
                if c == 0:
                    continue
                rows = order[start : start + c]
                start += c
                logits, _ = fused_masked_forward(pool.slot(s), obs[rows], mask[rows],
                                                 with_value=False)
                action[rows] = torch.argmax(logits, dim=-1)  # logits come masked
            if start < obs.shape[0]:
                rows = order[start:]
                action[rows] = first_legal(mask[rows])
            return action

    return policy

"""Fresh-game ring: amortized autoreset for lockstep batches.

Counterpart of `splendax/env/ring.py`.  Only ~1% of lanes finish per step,
so instead of dealing a fresh game for every lane every step, a ring of R
fresh games is dealt once and done lanes take its next entries in order:

    ring = make_ring(size, generator, device)         # once per rollout
    state, out, obs, mask, ring = step_autoreset_ring(state, action, ring)

Only the deal varies between fresh games (`deck_perm`, `board`,
`noble_ids`), so a ring entry is one int8 row of those 135 ids; the other
fields come from the blank state.  Done lanes take consecutive rows starting
at `ptr`.  `packed` repeats its first `window` rows after the ring, so a
take never wraps: lane i reads row `ptr + min(rank_i, window - 1)`, where
`rank_i` counts the done lanes before it.  Lanes beyond the window's end
(more than `window` games ending in one step) reuse the last row and are
counted in `overflow`, so a caller can assert that every fresh game was
distinct.  `ptr` and `overflow` stay on the device.

Under data parallelism every rank holds the same whole ring, with a window
of the global batch, and takes for its own rows: a done lane's rank counts
the done lanes before it on this rank and on every rank before it in the
dp group (one all-reduce of the per-rank counts a step), and `ptr` and
`overflow` advance by the global count, so the ranks take disjoint rows
and stay in step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..engine import data as D
from ..engine import rules
from ..engine.encode import encode_observation
from ..engine.state import GameState, blank_batch, initial_state
from ..ops import engine_ply
from ..ops.ring_take import take_rows
from ..parallel import collectives
from . import core

ACT_DIM = 45
DEFAULT_WINDOW = 4096

_VAR_FIELDS = (("deck_perm", (3, D.MAX_DECK)), ("board", (3, 4)), ("noble_ids", (3,)))
_VAR_SIZES = [int(np.prod(s)) for _, s in _VAR_FIELDS]
PACKED_WIDTH = sum(_VAR_SIZES)


@dataclass
class FreshGameRing:
    packed: torch.Tensor  # int8 [R + window, 135]: deck_perm | board | nobles
    mask0: torch.Tensor  # bool [45], the legal mask of every fresh game
    ptr: torch.Tensor  # int64 scalar, next entry to take
    overflow: torch.Tensor  # int64 scalar, lanes ever clamped to the window's end
    size: int  # R

    @property
    def window(self) -> int:
        return self.packed.shape[0] - self.size

    def replace(self, **kw) -> "FreshGameRing":
        return dataclasses.replace(self, **kw)


def _pack(state: GameState) -> torch.Tensor:
    """The deal fields [R, ...] -> int8 [R, 135]; every value is a card or
    noble id or -1, so int8 is exact."""
    R = state.batch_size
    return torch.cat([getattr(state, n).reshape(R, -1) for n, _ in _VAR_FIELDS], 1).to(torch.int8)


def _unpack_state(rows: torch.Tensor) -> GameState:
    """int8 [B, 135] -> GameState [B]: the deal from the rows, the rest
    from the blank state with 4 cards of each tier dealt."""
    B = rows.shape[0]
    fields = blank_batch(B, rows.device, exclude={n for n, _ in _VAR_FIELDS})
    fields["deck_count"] = trace.sync(  # a pageable copy, which blocks
        "ring.deck_count", lambda: torch.as_tensor(D.TIER_SIZES - 4, device=rows.device)
    ).expand(B, 3).clone()
    off = 0
    for (name, shape), size in zip(_VAR_FIELDS, _VAR_SIZES):
        fields[name] = rows[:, off : off + size].reshape((B,) + shape).to(torch.int32)
        off += size
    return GameState(**fields)


def make_ring(size: int, generator: torch.Generator, device="cuda",
              window: int = DEFAULT_WINDOW) -> FreshGameRing:
    """A ring of `size` freshly dealt games, with a take window of
    min(window, size) rows."""
    device = resolve_device(device)
    state = initial_state(size, generator, device)
    packed = _pack(state)
    w = min(window, size)
    if w < 1:
        raise ValueError("make_ring: the window must hold at least one row")
    packed = torch.cat([packed, packed[:w]], 0)
    return FreshGameRing(
        packed=packed,
        # The first legal mask does not depend on the deal: with no tokens
        # no card is affordable, and every take and reserve is legal.
        mask0=rules.legal_mask(state.map(lambda x: x[:1]))[0],
        ptr=torch.zeros((), dtype=torch.int64, device=device),
        overflow=torch.zeros((), dtype=torch.int64, device=device),
        size=size,
    )


def take(ring: FreshGameRing, done: torch.Tensor, mesh=None):
    """Hand each done lane the next unused fresh game.

    Returns (fresh_state [B], fresh_mask [B, 45], new ring).  Lanes that are
    not done get an arbitrary fresh row; the caller selects with `done`.
    With a `mesh` of dp > 1, `done` is this rank's rows and the take is the
    global one's (module docstring).
    """
    B = done.shape[0]
    W = ring.window
    incl = torch.cumsum(done, 0)
    rank = incl - done.long()  # done lanes before each lane
    n_done = incl[-1]
    if mesh is not None and mesh.dp > 1:
        counts = torch.zeros(mesh.dp, dtype=torch.int64, device=done.device)
        counts[mesh.dp_rank] = n_done
        collectives.all_reduce(counts, mesh.dp_group)
        rank = rank + counts[:mesh.dp_rank].sum()
        n_done = counts.sum()
    rows = take_rows(ring.packed, ring.ptr, rank, W)
    fresh_state = _unpack_state(rows)
    fresh_mask = ring.mask0.expand(B, ACT_DIM)
    new_ring = ring.replace(
        ptr=(ring.ptr + n_done) % ring.size,
        overflow=ring.overflow + torch.clamp(n_done - W, min=0),
    )
    return fresh_state, fresh_mask, new_ring


def step_autoreset_ring(state: GameState, action: torch.Tensor, ring: FreshGameRing,
                        rng_mode: str = "fast", mask=None, mesh=None):
    """`step` with done lanes reset from the ring.

    Returns (carry_state, out, obs_next, mask_next, ring): `out` keeps the
    terminal observation, reward and final rewards of each lane, while the
    carried state, obs and mask are the fresh game's where the lane is done.
    """
    kernels = engine_ply.takes(state.to_play, rng_mode)
    if kernels:
        next_state, fields, obs, _ = engine_ply.step(state, action, mask, with_obs=True)
    else:
        next_state, fields = core.step_core_plain(state, action, rng_mode=rng_mode, mask=mask)
        obs = encode_observation(next_state)
    done = fields["terminated"]
    fresh_state, _, ring = take(ring, done, mesh)
    # The encode and the mask are per-game functions, so computing them on
    # the selected carry equals selecting between fresh and stepped values.
    if kernels:
        carry, obs_next, mask_next = engine_ply.observe(next_state, fresh=fresh_state, done=done)
    else:
        carry = core.select(done, fresh_state, next_state)
        obs_next, mask_next = encode_observation(carry), rules.legal_mask(carry)
    out = core.StepOutput(
        obs=obs,
        action_mask=mask_next & ~done[:, None],
        **fields,
    )
    return carry, out, obs_next, mask_next, ring

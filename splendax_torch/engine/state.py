"""Batched Splendor game state: one tensor per field, batch first.

Counterpart of `splendax/engine/types.py`.  A `GameState` holds B games; each
field has the JAX field's shape with a leading batch axis, and the same dtype
(int32, or bool for `game_over` and `turn_limit_reached`).

Decks keep the full shuffled permutation per tier (`deck_perm[:, t]`, padded
to 40) plus a live count; "pop" reads `deck_perm[:, t, deck_count - 1]`.
`winner == -1` means no winner (draw or unset).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from . import data as D

NUM_PLAYERS = 2
NUM_NOBLES_VISIBLE = 3
TURN_LIMIT = 100  # full rounds; reaching it is a draw
TOKEN_CAP = 10  # most tokens a player may hold after a turn


@dataclass
class GameState:
    bank: torch.Tensor  # [B, 6] tokens by W,B,G,R,K,gold
    tokens: torch.Tensor  # [B, 2, 6]
    bonuses: torch.Tensor  # [B, 2, 5]
    prestige: torch.Tensor  # [B, 2]
    reserved_ids: torch.Tensor  # [B, 2, 3] card id or -1
    reserved_revealed: torch.Tensor  # [B, 2, 3] 1 if reserved from the board
    reserved_count: torch.Tensor  # [B, 2]
    player_nobles: torch.Tensor  # [B, 2, 3] noble id or -1
    noble_ids: torch.Tensor  # [B, 3] visible noble id or -1
    board: torch.Tensor  # [B, 3, 4] card id or -1
    deck_perm: torch.Tensor  # [B, 3, 40] shuffled card ids, -1 padded
    deck_count: torch.Tensor  # [B, 3]
    to_play: torch.Tensor  # [B]
    turn_count: torch.Tensor  # [B] full rounds, starts at 1
    move_count: torch.Tensor  # [B]
    game_over: torch.Tensor  # [B] bool
    winner: torch.Tensor  # [B] -1 none/draw, else player index
    turn_limit_reached: torch.Tensor  # [B] bool

    def replace(self, **kw) -> "GameState":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "GameState":
        """Apply `fn` to every field."""
        return GameState(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def items(self):
        return ((f.name, getattr(self, f.name)) for f in dataclasses.fields(self))

    @property
    def batch_size(self) -> int:
        return self.to_play.shape[0]


FIELDS = tuple(f.name for f in dataclasses.fields(GameState))


def _blank_state_np() -> dict:
    """One empty game (no deal), as numpy arrays of the JAX field dtypes."""
    return dict(
        bank=D.DEFAULT_BANK.copy(),
        tokens=np.zeros((NUM_PLAYERS, 6), np.int32),
        bonuses=np.zeros((NUM_PLAYERS, 5), np.int32),
        prestige=np.zeros(NUM_PLAYERS, np.int32),
        reserved_ids=np.full((NUM_PLAYERS, 3), -1, np.int32),
        reserved_revealed=np.zeros((NUM_PLAYERS, 3), np.int32),
        reserved_count=np.zeros(NUM_PLAYERS, np.int32),
        player_nobles=np.full((NUM_PLAYERS, 3), -1, np.int32),
        noble_ids=np.full(NUM_NOBLES_VISIBLE, -1, np.int32),
        board=np.full((3, 4), -1, np.int32),
        deck_perm=np.full((3, D.MAX_DECK), -1, np.int32),
        deck_count=np.zeros(3, np.int32),
        to_play=np.int32(0),
        turn_count=np.int32(1),
        move_count=np.int32(0),
        game_over=np.bool_(False),
        winner=np.int32(-1),
        turn_limit_reached=np.bool_(False),
    )


def blank_batch(B: int, device: torch.device, exclude=()) -> dict:
    """`_blank_state_np` broadcast to [B, ...] tensors on `device`.  On the
    card each field is a pageable host-to-device copy, which blocks: one
    `trace.sync` a call."""
    return trace.sync("state.blank", lambda: {
        k: torch.as_tensor(np.asarray(v), device=device).expand((B,) + np.shape(v)).clone()
        for k, v in _blank_state_np().items()
        if k not in exclude
    })


def initial_state(B: int, generator: torch.Generator, device="cuda") -> GameState:
    """B freshly dealt games: each tier's deck and the nobles shuffled.

    Each shuffle is an argsort of uniform draws from `generator`, so the deal
    stream differs from the JAX package's by design.  Board slot i takes the
    i-th pop from the deck's end, and the first 3 shuffled nobles are shown.
    """
    device = resolve_device(device)
    fields = blank_batch(B, device)
    for t in range(3):
        n = int(D.TIER_SIZES[t])
        u = torch.rand(B, n, generator=generator, device=device)
        perm = torch.argsort(u, dim=1).to(torch.int32) + int(D.TIER_OFFSETS[t])
        fields["deck_perm"][:, t, :n] = perm

        def deal():  # a list index and a Python number, copied from the host, block
            fields["board"][:, t] = perm[:, [n - 1, n - 2, n - 3, n - 4]]
            fields["deck_count"][:, t] = n - 4

        trace.sync("state.deal", deal)
    u = torch.rand(B, D.NUM_NOBLES, generator=generator, device=device)
    fields["noble_ids"] = torch.argsort(u, dim=1)[:, :NUM_NOBLES_VISIBLE].to(torch.int32)
    return GameState(**fields)


def initial_state_parity(seeds, device="cuda") -> GameState:
    """The freshly dealt game of each seed (an int, or a sequence for a
    batch), dealt on the host as the reference engine deals it: one CPython
    `random.Random(seed)` shuffles the tier-1 deck and pops 4 cards to board
    slots 0..3, the same for tiers 2 and 3, then shuffles the nobles and
    shows the first 3.  Equal to the JAX package's `initial_state_parity`
    on every field."""
    import random

    games = []
    for seed in [seeds] if isinstance(seeds, int) else list(seeds):
        rng = random.Random(seed)
        b = _blank_state_np()
        for t in range(3):
            n = int(D.TIER_SIZES[t])
            ids = list(range(int(D.TIER_OFFSETS[t]), int(D.TIER_OFFSETS[t]) + n))
            rng.shuffle(ids)
            for slot in range(4):
                b["board"][t, slot] = ids.pop()
            b["deck_perm"][t, : n - 4] = ids
            b["deck_count"][t] = n - 4
        nobles = list(range(D.NUM_NOBLES))
        rng.shuffle(nobles)
        b["noble_ids"] = np.asarray(nobles[:NUM_NOBLES_VISIBLE], np.int32)
        games.append(b)
    return from_numpy({k: np.stack([np.asarray(g[k]) for g in games]) for k in FIELDS}, device)


def from_numpy(arrays, device="cuda") -> GameState:
    """A GameState from a mapping (or object) of batched numpy arrays."""
    device = resolve_device(device)
    get = arrays.__getitem__ if isinstance(arrays, dict) else lambda k: getattr(arrays, k)
    return GameState(**{k: torch.as_tensor(np.asarray(get(k)), device=device) for k in FIELDS})


def to_numpy(state: GameState) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}

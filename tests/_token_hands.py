"""Fuzzed token-return inputs, shared by the CPU and the card tests (no JAX
here): B games whose mover holds 0 to 22 tokens, so every number of tokens
to return from 0 to 12 occurs, with gold-only hands, hands whose colours run
out before the cap is met (gold pays the rest), and a few unreachable hands
of 23 to 26 that use up all 12 draws and fall back to gold.  Either player
moves; turn_count reaches 2**20, across the 16-bit limb split of the seed."""

from __future__ import annotations

import numpy as np

TURN_EDGES = (0, 1, 99, 100, 65535, 65536, 65537, 131071, 131072, 2**20 - 1, 2**20)


def fuzzed_hands(rng: np.random.RandomState, B: int) -> dict:
    """numpy int32 arrays tokens [B, 2, 6], bank [B, 6], to_play and
    turn_count [B]."""
    total = rng.randint(0, 23, B)
    total = np.where(rng.rand(B) < 0.5, rng.randint(10, 23, B), total)
    total = np.where(rng.rand(B) < 0.03, rng.randint(23, 27, B), total)
    kind = rng.randint(0, 4, B)  # gold only; mixed; colours run out; colours only
    k = np.maximum(total - 10, 0)
    n_col = np.select(
        [kind == 0, kind == 1, kind == 2],
        [0, rng.binomial(total, 5 / 6), np.minimum(rng.randint(0, 10**6, B) % np.maximum(k, 1), total)],
        total)
    # Coloured tokens drawn among a random subset of 1 to 5 colours.
    perm = np.argsort(rng.rand(B, 5), 1)
    m = rng.randint(1, 6, B)
    pick = np.take_along_axis(perm, rng.randint(0, 10**6, (B, 26)) % m[:, None], 1)
    used = np.arange(26)[None] < n_col[:, None]
    hand = np.zeros((B, 6), np.int32)
    hand[:, :5] = ((pick[..., None] == np.arange(5)) & used[..., None]).sum(1)
    hand[:, 5] = total - n_col
    to_play = rng.randint(0, 2, B).astype(np.int32)
    tokens = rng.randint(0, 5, (B, 2, 6)).astype(np.int32)
    tokens[np.arange(B), to_play] = hand
    turn = rng.randint(1, 2**20 + 1, B).astype(np.int32)
    turn[:len(TURN_EDGES)] = TURN_EDGES[:B]
    return dict(tokens=tokens, bank=rng.randint(0, 8, (B, 6)).astype(np.int32),
                to_play=to_play, turn_count=turn)

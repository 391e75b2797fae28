"""Card and noble tables for the Splendor engine, as numpy constants.

The benchmark's frozen copy of `splendax_torch/engine/data.py` (the rules the
reference holds the port's engine to; it imports nothing of the port).

Read from this folder's own copy of `cards.json` and `nobles.json`.  Card
ids run 0..89 in file order (tier 1 = 0..39, tier 2 = 40..69, tier 3 =
70..89); -1 means "no card".  The feature
tables carry a leading all-zeros row, so `table[id + 1]` turns an absent card
into a zero vector.
"""

from __future__ import annotations

import json
import os

import numpy as np

TOKEN_COLORS = ("white", "blue", "green", "red", "black", "gold")
GOLD = 5  # index of gold in token vectors

NUM_CARDS = 90
NUM_NOBLES = 10
TIER_SIZES = np.array([40, 30, 20], dtype=np.int32)
TIER_OFFSETS = np.array([0, 40, 70], dtype=np.int32)
MAX_DECK = 40  # padding width of the per-tier deck permutation

DEFAULT_BANK = np.array([4, 4, 4, 4, 4, 5], dtype=np.int32)

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def _load() -> tuple[np.ndarray, ...]:
    with open(os.path.join(_DATA_DIR, "cards.json"), "r", encoding="utf-8") as f:
        cards = json.load(f)
    with open(os.path.join(_DATA_DIR, "nobles.json"), "r", encoding="utf-8") as f:
        nobles = json.load(f)

    tier = np.asarray(cards["tier"], dtype=np.int32)
    points = np.asarray(cards["points"], dtype=np.int32)
    color = np.asarray(cards["color"], dtype=np.int32)
    cost = np.asarray(cards["cost"], dtype=np.int32)
    if tier.shape != (NUM_CARDS,) or cost.shape != (NUM_CARDS, 5):
        raise ValueError("cards.json has unexpected shape")
    for t in (1, 2, 3):
        if int((tier == t).sum()) != int(TIER_SIZES[t - 1]):
            raise ValueError(f"cards.json must contain {TIER_SIZES[t-1]} tier-{t} cards")
    if not (np.sort(tier) == tier).all():
        raise ValueError("cards.json must be ordered tier 1, then 2, then 3")

    noble_points = np.asarray(nobles["points"], dtype=np.int32)
    noble_req = np.asarray(nobles["req"], dtype=np.int32)
    if noble_req.shape != (NUM_NOBLES, 5):
        raise ValueError("nobles.json must contain 10 nobles")
    return tier, points, color, cost, noble_points, noble_req


CARD_TIER, CARD_POINTS, CARD_COLOR, CARD_COST, NOBLE_POINTS, NOBLE_REQ = _load()

# 13-dim card features: [present, tier, points, color_onehot(5), cost(5)].
CARD_FEAT13 = np.zeros((NUM_CARDS + 1, 13), dtype=np.int32)
CARD_FEAT13[1:, 0] = 1
CARD_FEAT13[1:, 1] = CARD_TIER
CARD_FEAT13[1:, 2] = CARD_POINTS
CARD_FEAT13[np.arange(1, NUM_CARDS + 1), 3 + CARD_COLOR] = 1
CARD_FEAT13[1:, 8:13] = CARD_COST

# 6-dim noble features: [present, req(5)].
NOBLE_FEAT6 = np.zeros((NUM_NOBLES + 1, 6), dtype=np.int32)
NOBLE_FEAT6[1:, 0] = 1
NOBLE_FEAT6[1:, 1:] = NOBLE_REQ

# cost(5) | color | points per card, row 0 = the absent sentinel.
CARD7_PAD = np.zeros((NUM_CARDS + 1, 7), dtype=np.int32)
CARD7_PAD[1:, :5] = CARD_COST
CARD7_PAD[1:, 5] = CARD_COLOR
CARD7_PAD[1:, 6] = CARD_POINTS

# Take-3 combos: lexicographic 3-combinations of colors 0..4;
# COMBO_MASK[i, c] == 1 iff combo i includes color c.
TAKE3_COMBOS = tuple(
    (a, b, c) for a in range(5) for b in range(a + 1, 5) for c in range(b + 1, 5)
)
COMBO_MASK = np.zeros((10, 5), dtype=np.int32)
for _i, (_a, _b, _c) in enumerate(TAKE3_COMBOS):
    COMBO_MASK[_i, [_a, _b, _c]] = 1

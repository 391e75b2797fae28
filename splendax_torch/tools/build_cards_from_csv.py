"""CSV -> struct-of-arrays card-data builder.

Counterpart of `splendax/tools/build_cards_from_csv.py`: the reference's
one-shot data pipeline, emitting a compact struct-of-arrays JSON (`tier[]`,
`points[]`, `color[]`, `cost[][5]`) that loads straight into the engine's
integer tables (`splendax_torch.engine.data`).

The source spreadsheet lists the 90 base-game cards grouped by level with
carry-forward Level / Gem-color columns and five "Detailed price" columns in
(w)hite, bl(u)e, (g)reen, (r)ed, blac(k) order.  Card order in the output is the
CSV row order, which matches the reference's generated `cards.json` ordering —
this matters for seed-parity of deck shuffles.
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import List

# Internal canonical color order (matches reference engine/state.py:10-13).
STANDARD_COLORS = ["white", "blue", "green", "red", "black"]
COLOR_TO_IDX = {c: i for i, c in enumerate(STANDARD_COLORS)}

EXPECTED_TIER_COUNTS = {1: 40, 2: 30, 3: 20}


def parse_cards_csv(path: str) -> dict:
    """Parse the card spreadsheet into struct-of-arrays form.

    Returns a dict with parallel lists: tier (1..3), points, color (0..4 in
    W,B,G,R,K order), cost (list of 5 ints per card).
    """
    tiers: List[int] = []
    points: List[int] = []
    colors: List[int] = []
    costs: List[List[int]] = []

    with open(path, "r", encoding="utf-8") as f:
        rows = list(csv.reader(f))

    # Seek the header row (the one that names the Level column).
    header_i = None
    for i, row in enumerate(rows):
        if row and row[0].strip().lower() == "level":
            header_i = i
            break
    if header_i is None:
        raise ValueError(f"Could not find header row in {path}")

    cur_tier = None
    cur_color = None
    for row in rows[header_i + 1 :]:
        if not row or len(row) < 10:
            continue
        lvl = row[0].strip()
        gem = row[1].strip().lower()
        pv = row[2].strip()
        price = row[3].strip()
        if lvl:
            cur_tier = int(lvl)
        if gem:
            if gem not in COLOR_TO_IDX:
                raise ValueError(f"Unknown gem color {gem!r}")
            cur_color = COLOR_TO_IDX[gem]
        if not price:
            continue  # not a card row
        if cur_tier is None or cur_color is None:
            raise ValueError("Card row before tier/color established")
        cost = []
        for c in range(5):
            cell = row[5 + c].strip()
            cost.append(int(cell) if cell else 0)
        tiers.append(cur_tier)
        points.append(int(pv) if pv else 0)
        colors.append(cur_color)
        costs.append(cost)

    for t, want in EXPECTED_TIER_COUNTS.items():
        got = sum(1 for x in tiers if x == t)
        if got != want:
            raise ValueError(f"Tier {t}: expected {want} cards, parsed {got}")

    return {
        "colors_order": STANDARD_COLORS,
        "tier": tiers,
        "points": points,
        "color": colors,
        "cost": costs,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("csv_path", help="Path to the Splendor card list CSV")
    ap.add_argument(
        "-o",
        "--out",
        default=None,
        help="Output JSON path (default: splendax_torch/engine/data/cards.json)",
    )
    args = ap.parse_args(argv)
    out = args.out
    if out is None:
        import os

        out = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "engine",
            "data",
            "cards.json",
        )
    data = parse_cards_csv(args.csv_path)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(data, f, separators=(",", ":"))
    n = len(data["tier"])
    print(f"Wrote {n} cards -> {out}")


if __name__ == "__main__":
    main()

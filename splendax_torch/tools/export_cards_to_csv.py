"""Struct-of-arrays card tables -> card-list CSV exporter.

Counterpart of `splendax/tools/export_cards_to_csv.py`, and the inverse of
`build_cards_from_csv`: re-derives the raw card spreadsheet (the format of
the reference's `Splendor cards list.csv`) from this package's
`engine/data/cards.json`.  `data/splendor_cards.csv` at the repo root is its
output, and `build_cards_from_csv` regenerates `cards.json` from it
byte-identically (tests/test_torch_tools.py).

Format notes (must stay parseable by `parse_cards_csv`):
- preamble row, then a header row whose first cell is "Level";
- Level and Gem color columns are carry-forward (written only on change);
- PV blank for 0-point cards;
- "Price" is the compact human string (e.g. "1w+2u"), always non-empty for a
  card row (the parser uses it to distinguish card rows);
- five "Detailed price" columns in (w)hite, bl(u)e, (g)reen, (r)ed, blac(k)
  order, blank for 0.
"""

from __future__ import annotations

import argparse
import csv
import os

PRICE_LETTERS = ("w", "u", "g", "r", "k")  # white, blue, green, red, black


def compact_price(cost) -> str:
    parts = [f"{int(n)}{c}" for n, c in zip(cost, PRICE_LETTERS) if int(n) > 0]
    return "+".join(parts)


def export_rows(data: dict) -> list:
    """Build CSV rows (lists of str) from struct-of-arrays card data."""
    colors = data["colors_order"]
    rows = [
        ["", "", "", "", "", "Detailed price", "", "", "", ""],
        ["Level", "Gem color", "PV", "Price", "Illustration",
         "(w)hite", "bl(u)e", "(g)reen", "(r)ed", "blac(k)"],
    ]
    prev_tier = None
    prev_color = None
    for tier, pv, color, cost in zip(
        data["tier"], data["points"], data["color"], data["cost"]
    ):
        lvl = str(tier) if tier != prev_tier else ""
        if tier != prev_tier:
            prev_color = None  # color column restates at each new level
        gem = colors[color] if color != prev_color else ""
        prev_tier, prev_color = tier, color
        detailed = [str(int(c)) if int(c) else "" for c in cost]
        rows.append(
            [lvl, gem, str(int(pv)) if int(pv) else "", compact_price(cost), ""]
            + detailed
        )
    return rows


def export_csv(out_path: str) -> int:
    """Write the shipped card tables as a CSV; returns the card count."""
    from ..engine import data as D

    data = {
        "colors_order": list(D.TOKEN_COLORS[:5]),
        "tier": D.CARD_TIER.tolist(),
        "points": D.CARD_POINTS.tolist(),
        "color": D.CARD_COLOR.tolist(),
        "cost": D.CARD_COST.tolist(),
    }
    rows = export_rows(data)
    with open(out_path, "w", encoding="utf-8", newline="") as f:
        csv.writer(f).writerows(rows)
    return len(rows) - 2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "-o", "--out",
        default=os.path.join(os.getcwd(), "data", "splendor_cards.csv"),
        help="Output CSV path (default: ./data/splendor_cards.csv)",
    )
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    n = export_csv(args.out)
    print(f"Wrote {n} cards -> {args.out}")


if __name__ == "__main__":
    main()

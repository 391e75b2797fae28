#!/usr/bin/env python3
"""Hold the port's Elo ladder against a committed one.

    python3 scripts/torch_ladder_compare.py [PORT_JSON] [REFERENCE_JSON] \
        [--leave-out KEY=REASON ...] [--duel] [--no-limit KEY=REASON ...]

PORT_JSON defaults to runs/elo_ladder_torch.json (`python -m
splendax_torch.eval.ladder`), REFERENCE_JSON to runs/elo_ladder.json (the
JAX package's ladder).  For every pair both files hold (a key stored as
`b:a` on one side is oriented to `a:b` by taking 1 - score):

    z = (s_port - s_ref) / se,  se = sqrt((ci_port / 1.96)^2 + (ci_ref / 1.96)^2),

with se floored at 0.5 / min(n_pairs), so a pair that both sides swept (ci
0) still has a scale.  Both pair sets are then refit with the Bradley-Terry
fit on the non-search agents that both ladders rate, and each agent's Elo
is printed beside the other's with both `privileged` flags.

Exits 1 when a limit is broken: more than 10% of the compared pairs with
|z| > 1.96, a pair with |z| > 4, a refit Elo more than 50 from the
reference's, or a `privileged` flag that differs.  --leave-out takes a pair
out of the comparison; the reason is printed beside it.  With --duel the two
files are `python -m splendax_torch.eval.search_duel` (or `eval.cli
--both-seats`) JSONs: each duel both hold gets its z, and the limit is
|z| <= 4.  A result without `n_pairs` comes from the older unpaired
head-to-head: its floor takes n // 2, the games of one seat order, and the
row names the reference's protocol ("paired" or "unpaired").  --no-limit
prints a duel's z with the reason beside it and keeps it out of the exit
code.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

Z_SHARE, Z_SHARE_LIMIT, Z_MAX, ELO_MAX = 1.96, 0.10, 4.0, 50.0


def oriented(pairs: dict, a: str, b: str):
    """(score of a, ci95, n_pairs) of the pair a, b as `pairs` holds it,
    either way round; None where it lacks the pair."""
    if f"{a}:{b}" in pairs:
        r = pairs[f"{a}:{b}"]
        return r["score"], r["score_ci95"], r["n_pairs"]
    if f"{b}:{a}" in pairs:
        r = pairs[f"{b}:{a}"]
        return 1.0 - r["score"], r["score_ci95"], r["n_pairs"]
    return None


def z_row(key, port, ref):
    """(key, s_port, s_ref, se, z) from two (score, ci95, n_pairs)."""
    (s_p, ci_p, n_p), (s_r, ci_r, n_r) = port, ref
    se = max(math.hypot(ci_p / 1.96, ci_r / 1.96), 0.5 / min(n_p, n_r))
    return key, s_p, s_r, se, (s_p - s_r) / se


def pair_z(port_pairs: dict, ref_pairs: dict) -> list:
    """One row per pair both hold, keyed as the port holds it."""
    rows = []
    for key in port_pairs:
        a, b = key.split(":")
        ref = oriented(ref_pairs, a, b)
        if ref is not None:
            rows.append(z_row(key, oriented(port_pairs, a, b), ref))
    return rows


def protocol(result: dict) -> str:
    """"paired" for a head-to-head on the same deals in both seat orders
    (it records `n_pairs`), "unpaired" for the older protocol."""
    return "paired" if "n_pairs" in result else "unpaired"


def duel_z(port: dict, ref: dict) -> list:
    """One row (key, s_port, s_ref, se, z, the reference's protocol) per
    duel both files hold (`eval/search_duel.py`'s JSON: `{"<tag_a>_vs_<tag_b>":
    result}`).  The se floor's game count is `n_pairs`, or n // 2 where the
    result lacks it."""
    return [(*z_row(key, *((d[key]["score"], d[key]["score_ci95"],
                            d[key].get("n_pairs", d[key]["n"] // 2)) for d in (port, ref))),
             protocol(ref[key]))
            for key in port if key in ref]


def refit(pairs: dict, agents: list) -> dict:
    """Bradley-Terry Elo of `agents` from the pairs among them alone."""
    from splendax_torch.eval.elo import bradley_terry_elo
    from splendax_torch.eval.ladder import score_table

    return dict(zip(agents, (float(e) for e in bradley_terry_elo(*score_table(pairs, agents)))))


def compare(port: dict, ref: dict, leave_out: dict | None = None) -> dict:
    """The z rows, the refit Elo rows and every broken limit."""
    from splendax_torch.eval.ladder import SEARCH_ROSTER

    leave_out = leave_out or {}
    rows = [r for r in pair_z(port["pairs"], ref["pairs"]) if r[0] not in leave_out]
    search = {label for label, _, _ in SEARCH_ROSTER}
    kept = {k: v for k, v in port["pairs"].items() if k not in leave_out}
    kept_ref = {k: v for k, v in ref["pairs"].items()
                if k not in leave_out and ":".join(reversed(k.split(":"))) not in leave_out}
    rated = [l for l in port["labels"] if l not in search
             and any(l in k.split(":") for k in kept)
             and any(l in k.split(":") for k in kept_ref)]
    elo_p, elo_r = refit(kept, rated), refit(kept_ref, rated)
    elo_rows = [(l, elo_p[l], elo_r[l], port["privileged"].get(l), ref["privileged"].get(l))
                for l in rated]
    broken = []
    wide = [r for r in rows if abs(r[4]) > Z_SHARE]
    if rows and len(wide) > Z_SHARE_LIMIT * len(rows):
        broken.append(f"{len(wide)} of {len(rows)} pairs have |z| > {Z_SHARE} "
                      f"(at most {Z_SHARE_LIMIT:.0%})")
    broken += [f"{k}: |z| = {abs(z):.2f} > {Z_MAX}" for k, *_, z in rows if abs(z) > Z_MAX]
    broken += [f"{l}: refit Elo {p:.1f} vs {r:.1f}, {abs(p - r):.1f} apart (at most {ELO_MAX})"
               for l, p, r, *_ in elo_rows if abs(p - r) > ELO_MAX]
    common = [l for l in port["privileged"] if l in ref["privileged"]]
    broken += [f"{l}: privileged {port['privileged'][l]} vs {ref['privileged'][l]}"
               for l in common if port["privileged"][l] != ref["privileged"][l]]
    return {"rows": rows, "elo": elo_rows, "broken": broken, "left_out": leave_out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("port", nargs="?", default=os.path.join(ROOT, "runs",
                                                            "elo_ladder_torch.json"))
    ap.add_argument("reference", nargs="?", default=os.path.join(ROOT, "runs",
                                                                 "elo_ladder.json"))
    ap.add_argument("--leave-out", action="append", default=[], metavar="KEY=REASON",
                    help="take the pair KEY out of the comparison, for REASON")
    ap.add_argument("--duel", action="store_true",
                    help="the two files are search duels' JSON: print each duel's z, "
                         "exit 1 above |z| = 4")
    ap.add_argument("--no-limit", action="append", default=[], metavar="KEY=REASON",
                    help="--duel: print the duel KEY's z but hold it to no limit, for REASON")
    args = ap.parse_args(argv)
    with open(args.port) as f:
        port = json.load(f)
    with open(args.reference) as f:
        ref = json.load(f)
    if args.duel:
        no_limit = dict(item.split("=", 1) for item in args.no_limit)
        rows = duel_z(port, ref)
        for key, s_p, s_r, se, z, proto in rows:
            print(f"{key}: port {s_p:.4f}, reference {s_r:.4f} ({proto}), se {se:.4f}, z {z:.3f}"
                  + (f"; no limit: {no_limit[key]}" if key in no_limit else ""))
        return 1 if not rows or any(abs(r[4]) > Z_MAX for r in rows if r[0] not in no_limit) else 0
    leave_out = dict(item.split("=", 1) for item in args.leave_out)
    out = compare(port, ref, leave_out)
    rows = out["rows"]
    print(f"{'pair':<44s} {'port':>7s} {'ref':>7s} {'se':>7s} {'z':>7s}")
    for key, s_p, s_r, se, z in rows:
        flag = " *" if abs(z) > Z_SHARE else ""
        print(f"{key:<44s} {s_p:7.4f} {s_r:7.4f} {se:7.4f} {z:7.3f}{flag}")
    for key, reason in leave_out.items():
        print(f"left out {key}: {reason}")
    n_wide = sum(abs(r[4]) > Z_SHARE for r in rows)
    print(f"{len(rows)} pairs compared: {n_wide} with |z| > {Z_SHARE}, max |z| "
          f"{max((abs(r[4]) for r in rows), default=0.0):.3f}")
    print(f"{'agent':<28s} {'Elo port':>9s} {'Elo ref':>9s} {'diff':>7s}  privileged port/ref")
    for l, p, r, pp, pr in sorted(out["elo"], key=lambda e: -e[2]):
        print(f"{l:<28s} {p:9.1f} {r:9.1f} {p - r:7.1f}  {pp}/{pr}")
    for msg in out["broken"]:
        print(f"BROKEN: {msg}")
    print("within the limits" if not out["broken"] else f"{len(out['broken'])} limits broken")
    return 1 if out["broken"] else 0


if __name__ == "__main__":
    sys.exit(main())

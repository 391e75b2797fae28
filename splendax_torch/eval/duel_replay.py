"""Replay of the committed search duels and league evals.

Counterpart of the five round scripts, `scripts/round4_duels.sh`,
`round4_duels2.sh`, `round4_headline_evals.sh`,
`round5_censored_league_evals.sh` and `round5_league_control_evals.sh`,
which wrote `runs/search_duels/`.  MANIFEST holds one entry per file there
(and per file a round script writes that is not committed): its runner
(`eval.search_duel` or `eval.cli`), the script's arguments with its games
and seeds, and its limit class.  Committed files that no round script
wrote take their arguments from the file's own key and `n` (seed 0 unless
the name says `seed1`).

Each entry runs in this process through `search_duel.main(argv, device)` or
`cli.main(argv, device)` and is written to `<out-dir>/<same name>.json`
through a temporary file and `os.replace`; a file already there is kept
unless `--force`.  Then each written file is held against its committed one
by `scripts/torch_ladder_compare.py --duel` (the z of the score, its se
floored at 0.5 / games of one seat order):

  held       |z| <= 4: the round-4 and round-5 duels and the model evals;
  reported   the z is printed with no limit: the six files without a round
             suffix, which predate the JAX package's round-4 Gumbel fix
             (`scripts/round4_duels.sh:9-10`) and its paired head-to-head;
  written    played and written, compared with nothing: the headline
             `--agent basic` runs, which were never committed.

LEFT_OUT names what is not replayed, with the reason.  The port's deals are
not JAX's (the torch generator deals), so a file is held by z, not by game.

Runs on the GPU; `main(argv, device="cpu")` runs it on the CPU.

Usage:
  python -m splendax_torch.eval.duel_replay                        # all, at the scripts' games
  python -m splendax_torch.eval.duel_replay --only uct_vs_gumbel_h768 --games 16 \\
      --out-dir /tmp/replay                                        # a cut
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COMMITTED_DIR = os.path.join(ROOT, "runs", "search_duels")
DEFAULT_OUT = os.path.join(ROOT, "runs", "search_duels_torch")
COMPARATOR = os.path.join(ROOT, "scripts", "torch_ladder_compare.py")

HELD, REPORTED, WRITTEN = "held", "reported", "written"
REPORTED_REASON = ("predates the round-4 Gumbel fix (scripts/round4_duels.sh:9-10) and the "
                   "paired head-to-head")
# Arguments that name a file of the repository, given relative to its root.
PATH_FLAGS = ("--npz", "--opp-npz", "--search-npz", "--torch-pt")

NPZ = "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"
CENS = "runs/ppo_splendor_500m_search_censored_s43/ppo_splendor_params.npz"
PRIV = L43 = "runs/ppo_splendor_500m_search_static_s43/ppo_splendor_params.npz"
L42 = "runs/ppo_splendor_500m_search/ppo_splendor_params.npz"
U42 = "runs/ppo_splendor_500m_uniform/ppo_splendor_params.npz"
WM = "runs/ppo_splendor_1750m_uniform_wallmatch/ppo_splendor_params.npz"


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str  # the JSON file's name without ".json"
    runner: str  # "search_duel" or "cli"
    argv: tuple  # the script's arguments, without --json-out
    limit: str  # HELD, REPORTED or WRITTEN
    source: str  # where the arguments come from


def _duel(name, a, b, games, source, limit=HELD, extra=()):
    return Entry(name, "search_duel",
                 ("--npz", NPZ, "--a", a, "--b", b, *extra, "--games", str(games)), limit, source)


def _eval(name, command, npz, source, opp=None):
    opp_args = ("--opp-npz", opp) if opp else ()
    return Entry(name, "cli", (command, "--npz", npz, *opp_args, "--games", "400",
                               "--both-seats"), HELD, source)


def _headline(name, algo, source):
    return Entry(name, "cli", ("vs-search", "--algo", algo, "--greedy-final", "--gumbel-m", "16",
                               "--gumbel-k0", "6", "--horizon", "4", "--search-npz", NPZ,
                               "--agent", "basic", "--games", "100", "--both-seats"),
                 WRITTEN, source)


GF = ("--greedy-final",)
K12 = ("--gumbel-k0", "12", "--greedy-final")
MANIFEST = [
    _duel("gumbel_vs_greedy_h768_r4", "gumbel", "greedy", 100, "scripts/round4_duels.sh:34"),
    _duel("gumbel_vs_mc_h768_r4", "gumbel", "mc", 100, "scripts/round4_duels.sh:35"),
    _duel("cmc_vs_greedy_h768_r4", "cmc", "greedy", 100, "scripts/round4_duels.sh:36"),
    _duel("cmc_vs_mc_h768_r4", "cmc", "mc", 100, "scripts/round4_duels.sh:37"),
    _duel("cgumbel_vs_greedy_h768_r4", "cgumbel", "greedy", 100, "scripts/round4_duels.sh:38"),
    _duel("cgumbel_vs_gumbel_h768_r4", "cgumbel", "gumbel", 100, "scripts/round4_duels.sh:39"),
    _duel("gumbelgf_vs_greedy_h768_r4", "gumbel", "greedy", 100, "scripts/round4_duels2.sh:16",
          extra=GF),
    _duel("gumbelgf_vs_mc_h768_r4", "gumbel", "mc", 100, "scripts/round4_duels2.sh:21", extra=GF),
    _duel("cgumbelgf_vs_greedy_h768_r4", "cgumbel", "greedy", 100,
          "scripts/round4_duels2.sh:26", extra=GF),
    _headline("basic_vs_gumbelgf_r4", "gumbel", "scripts/round4_headline_evals.sh:14"),
    _headline("basic_vs_cgumbelgf_r4", "cgumbel", "scripts/round4_headline_evals.sh:26"),
    _eval("censored_vs_priv_league_s43", "vs-model", CENS,
          "scripts/round5_censored_league_evals.sh:15", opp=PRIV),
    _eval("censored_league_vs_basic_s43", "vs-basic", CENS,
          "scripts/round5_censored_league_evals.sh:20"),
    _eval("league_s43_vs_uniform", "vs-model", L43, "scripts/round5_league_control_evals.sh:19",
          opp=U42),
    _eval("league_s43_vs_basic", "vs-basic", L43, "scripts/round5_league_control_evals.sh:24"),
    _eval("league_s42_vs_wallmatch", "vs-model", L42, "scripts/round5_league_control_evals.sh:29",
          opp=WM),
    _eval("wallmatch_vs_basic", "vs-basic", WM, "scripts/round5_league_control_evals.sh:34"),
    _eval("league_s43_vs_league_s42", "vs-model", L43,
          "scripts/round5_league_control_evals.sh:39", opp=L42),
    # Committed, written by no round script: the arguments from the file's key and n.
    _duel("gumbelgf_vs_mc_h768_r5paired", "gumbel", "mc", 100, "the file's key", extra=GF),
    _duel("cgumbelgf_k12_vs_greedy_h768_r5", "cgumbel", "greedy", 100, "the file's key",
          extra=K12),
    _duel("cgumbelfk12_vs_cmc_h768_r5", "cgumbel", "cmc", 100, "the file's key", extra=K12),
    _duel("gumbel_vs_greedy_h768", "gumbel", "greedy", 100, "the file's key", REPORTED),
    _duel("gumbel_vs_mc_h768", "gumbel", "mc", 200, "the file's key", REPORTED),
    _duel("gumbel_vs_mc_h768_seed1", "gumbel", "mc", 400, "the file's key", REPORTED,
          extra=("--seed", "1")),
    _duel("mc_vs_greedy_h768", "mc", "greedy", 100, "the file's key", REPORTED),
    _duel("uct_vs_greedy_h768", "uct", "greedy", 100, "the file's key", REPORTED),
    _duel("uct_vs_gumbel_h768", "uct", "gumbel", 100, "the file's key", REPORTED),
]
BY_NAME = {e.name: e for e in MANIFEST}
# Files a round script writes that are not replayed, with the reason.
LEFT_OUT = {
    "refckpt_vs_gumbelgf_r4": "scripts/round4_headline_evals.sh:20: its --torch-pt names the "
                              "reference implementation's checkpoint, which lies outside the "
                              "repository",
}


def argv_for(entry: Entry, games: int | None = None) -> list:
    """The entry's arguments with every file made absolute under the
    repository and, given `games`, that many games a seat order."""
    argv = list(entry.argv)
    for i, a in enumerate(argv[:-1]):
        if a in PATH_FLAGS:
            argv[i + 1] = os.path.join(ROOT, argv[i + 1])
        elif a == "--games" and games is not None:
            argv[i + 1] = str(games)
    return argv


def play(entry: Entry, games: int | None = None, device="cuda") -> dict:
    """Run the entry in this process; returns the JSON it would write."""
    from . import cli, search_duel

    runner = search_duel.main if entry.runner == "search_duel" else cli.main
    return runner(argv_for(entry, games), device=device)


def write_json(path: str, payload: dict) -> None:
    """`payload` as the round scripts write it (indent 2), through a temporary file
    in the same directory and `os.replace`."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".replay-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def comparator():
    """`scripts/torch_ladder_compare.py`, loaded from the checkout."""
    spec = importlib.util.spec_from_file_location("torch_ladder_compare", COMPARATOR)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", action="append", default=[], metavar="NAME",
                    help="replay the entry NAME alone (repeatable; default: every entry)")
    ap.add_argument("--games", type=int, default=None,
                    help="games a seat order for every entry (default: each script's)")
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true", help="replay files already written")
    ap.add_argument("--device", default=None, help="default: the card (or main's device)")
    return ap


def main(argv=None, device="cuda") -> dict:
    """Replay the entries, write their files, hold each against its
    committed file.  Returns {"entries": {name: {...}}, "left_out": LEFT_OUT,
    "above": held files with |z| > 1.96, "broken": broken limits}."""
    from ..device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device or device)
    out_dir = os.path.realpath(args.out_dir)
    committed = os.path.realpath(COMMITTED_DIR)
    if os.path.commonpath([out_dir, committed]) == committed:
        raise SystemExit(f"--out-dir {args.out_dir} lies in {COMMITTED_DIR}, the committed "
                         "reference")
    for name in args.only:
        if name in LEFT_OUT:
            raise SystemExit(f"{name} is left out: {LEFT_OUT[name]}")
        if name not in BY_NAME:
            raise SystemExit(f"no manifest entry {name!r}")
    entries = [BY_NAME[n] for n in args.only] if args.only else MANIFEST
    os.makedirs(out_dir, exist_ok=True)
    compare = comparator()
    report, broken, above = {}, [], []
    for e in entries:
        path = os.path.join(out_dir, e.name + ".json")
        seconds = None
        if os.path.exists(path) and not args.force:
            print(f"[replay] {e.name}: {path} is there, kept", flush=True)
        else:
            print(f"[replay] {e.name} ({e.runner} {' '.join(e.argv)})", flush=True)
            t0 = time.perf_counter()
            payload = play(e, args.games, device)  # its numbers are on the host
            seconds = time.perf_counter() - t0
            write_json(path, payload)
        report[e.name] = row = {"limit": e.limit, "source": e.source, "file": path,
                                "seconds": seconds, "rows": []}
        ref = os.path.join(COMMITTED_DIR, e.name + ".json")
        if e.limit == WRITTEN:
            continue
        with open(path) as f:
            port = json.load(f)
        with open(ref) as f:
            row["rows"] = compare.duel_z(port, json.load(f))
        no_limit = ([f"--no-limit={key}={REPORTED_REASON}" for key in port]
                    if e.limit == REPORTED else [])
        rc = compare.main(["--duel", path, ref, *no_limit])
        if rc != 0:
            broken.append(f"{e.name}: " + ("no duel in both files" if not row["rows"] else
                                           f"|z| = {abs(row['rows'][0][4]):.3f} > {compare.Z_MAX}"))
        if e.limit == HELD:
            above += [e.name for r in row["rows"] if abs(r[4]) > compare.Z_SHARE]
    held = [n for n, r in report.items() if r["limit"] == HELD]
    print(f"{'file':<36s} {'port':>7s} {'committed':>9s} {'z':>7s}  protocol  limit", flush=True)
    for name, r in report.items():
        for key, s_p, s_r, se, z, proto in r["rows"]:
            print(f"{name:<36s} {s_p:7.4f} {s_r:9.4f} {z:7.3f}  {proto:<8s}  {r['limit']}")
        if r["limit"] == WRITTEN:
            print(f"{name:<36s} written, compared with nothing")
    for name, reason in LEFT_OUT.items():
        print(f"left out {name}: {reason}")
    print(f"{len(held)} held files: {len(above)} with |z| > {compare.Z_SHARE} "
          f"({', '.join(above) or 'none'}); " + ("within the limits" if not broken else
                                                 f"{len(broken)} limits broken"), flush=True)
    for msg in broken:
        print(f"BROKEN: {msg}", flush=True)
    return {"entries": report, "left_out": dict(LEFT_OUT), "above": above, "broken": broken}


if __name__ == "__main__":
    sys.exit(1 if main()["broken"] else 0)

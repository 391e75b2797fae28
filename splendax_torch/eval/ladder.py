"""All-agents Elo ladder: one round robin over the committed roster.

Counterpart of `scripts/elo_ladder.py`, with the same roster, flags, pair
schedule, seeds and JSON.  Every pair plays a seat-averaged,
paired-deal `suite.head_to_head`; ratings come from the Bradley-Terry fit of
`eval/elo.py`, anchored at mean 1000.

Privileged agents (search bots that read the full GameState) are flagged in
the output's `privileged` map and left out of the default roster;
`--include-search` adds the privileged searches and the censored
(information-set) ones.  A search bot plays only the `--search-core`
members and the other search bots.

Incremental: the JSON is rewritten after every pair (through a temporary
file and `os.replace`), and pairs already in it are never replayed.  Labels
found only in those prior pairs stay in the fit.  The committed ladder of
the JAX package, `runs/elo_ladder.json`, is the reference the port is held
against (`scripts/torch_ladder_compare.py`): this module neither writes nor
resumes from it, and writes `runs/elo_ladder_torch.json` by default.

The `reference_ckpt` row reads a checkpoint that is not in the repository
yet; the ladder builds it only where `runs/reference_ckpt/` holds the file.

Runs on the GPU; `main(argv, device="cpu")` runs it on the CPU.

Usage:
  python -m splendax_torch.eval.ladder --games 100                  # nets and bots
  python -m splendax_torch.eval.ladder --games 100 --search-games 50 --include-search
"""

from __future__ import annotations

import argparse
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUNS = os.path.join(ROOT, "runs")
# The JAX package's committed ladder: the reference, never written here.
COMMITTED = os.path.join(RUNS, "elo_ladder.json")
DEFAULT_OUT = os.path.join(RUNS, "elo_ladder_torch.json")
# The reference implementation's checkpoint (the JAX script's
# `reference_ckpt` row), looked for only inside this checkout: the row waits
# until the file is committed there.
REFERENCE_CKPT = os.path.join(RUNS, "reference_ckpt", "ppo_splendor_latest.pt")


def NET(run: str) -> str:
    return os.path.join(RUNS, run, "ppo_splendor_params.npz")


# (label, kind, spec); kind: heuristic | npz | torch | search.
# Search specs: (algo, label of the npz net it searches with, kwargs).
ROSTER = [
    ("random", "heuristic", "random"),
    ("greedy_v1", "heuristic", "greedy_v1"),
    ("basic", "heuristic", "basic"),
    ("noble", "heuristic", "noble"),
    ("reference_ckpt", "torch", REFERENCE_CKPT),
    ("ppo_100m", "npz", NET("ppo_splendor_100m")),
    ("ppo_1b", "npz", NET("ppo_splendor_1b")),
    ("ppo_2b_h256", "npz", NET("ppo_splendor_2b")),
    ("ppo_2b_h512", "npz", NET("ppo_splendor_2b_h512")),
    ("ppo_2b_h768", "npz", NET("ppo_splendor_2b_h768")),
    ("ppo_2b_h1024", "npz", NET("ppo_splendor_2b_h1024")),
    ("ppo_500m_uniform", "npz", NET("ppo_splendor_500m_uniform")),
    ("ppo_500m_pfsp", "npz", NET("ppo_splendor_500m_pfsp")),
    # The committed ladder's "ppo_500m_league" row was measured on a net
    # that was never committed; its pairs stay in that file as evidence.
    ("ppo_500m_league_bern", "npz", NET("ppo_splendor_500m_search")),
    ("ppo_500m_league_s43", "npz", NET("ppo_splendor_500m_search_static_s43")),
]
# Added to the roster where the file exists.
OPTIONAL_NETS = [
    ("ppo_2b_h768_league", "npz", NET("ppo_splendor_2b_h768_league")),
    ("ppo_500m_league_cens_s43", "npz", NET("ppo_splendor_500m_search_censored_s43")),
    ("ppo_1750m_wallmatch", "npz", NET("ppo_splendor_1750m_uniform_wallmatch")),
]
# Search bots over the h768 net at the duels' sizes (`eval/search_duel.py`):
# gumbel_gf and mc read the true state; cmc and cgumbel_gf are the
# information-set variants.
SEARCH_ROSTER = [
    ("gumbel_gf_h768", "search", ("gumbel", "ppo_2b_h768",
                                  dict(m=16, k0=6, horizon=4, greedy_final=True))),
    ("mc_h768", "search", ("mc", "ppo_2b_h768", dict(rollouts=8, horizon=4))),
    ("cmc_h768", "search", ("cmc", "ppo_2b_h768", dict(rollouts=8, horizon=4))),
    ("cgumbel_gf_h768", "search", ("cgumbel", "ppo_2b_h768",
                                   dict(m=16, k0=6, horizon=4, greedy_final=True))),
]
# The search specs' sizes under `eval/search_duel.py`'s flag names.
DUEL_FLAGS = {"m": "gumbel_m", "k0": "gumbel_k0"}
# Privilege flags of labels that may appear only in prior pairs.
KNOWN_PRIVILEGED = {"gumbel_gf_h768": True, "mc_h768": True,
                    "cmc_h768": False, "cgumbel_gf_h768": False,  # information-set
                    "ppo_500m_league": False}  # an observation-only net


def build_policy(label, kind, spec, nets, device="cuda"):
    """The PolicySpec of one roster entry; `nets` maps npz labels to their
    loaded `ActorCritic`s."""
    from . import search_duel, suite

    if kind == "heuristic":
        return suite.heuristic_policy(spec)
    if kind == "npz":
        return suite.model_greedy_policy(nets[label])
    if kind == "torch":
        from .cli import _load_params

        return suite.model_greedy_policy(
            _load_params(argparse.Namespace(npz=None, torch_pt=spec), device))
    if kind == "search":
        # The duel's bot at the duel's defaults (c_scale, sims), with the
        # roster's sizes in place of its flags.
        algo, net_label, kw = spec
        args = search_duel.build_parser().parse_args([])
        for k, v in kw.items():
            setattr(args, DUEL_FLAGS.get(k, k), v)
        return search_duel.build(algo, args, nets[net_label])[0]
    raise SystemExit(f"unknown roster entry kind {kind!r}")


def roster_entries(include_search: bool) -> list:
    """The roster's entries whose files exist, in the ladder's order."""
    roster = [e for e in ROSTER if e[1] != "torch" or os.path.exists(e[2])]
    roster += [e for e in OPTIONAL_NETS if os.path.exists(e[2])]
    return roster + (SEARCH_ROSTER if include_search else [])


def build_roster(include_search: bool, device="cuda"):
    """(roster, policies, privileged): `roster_entries`, each npz net loaded
    once on `device` and every policy built."""
    from ..models.actor_critic import import_params_npz
    from . import suite

    roster = roster_entries(include_search)
    nets = {label: import_params_npz(spec, device=device)
            for label, kind, spec in roster if kind == "npz"}
    policies = {label: build_policy(label, kind, spec, nets, device)
                for label, kind, spec in roster}
    privileged = {label: suite.is_privileged(pol) for label, pol in policies.items()}
    return roster, policies, privileged


def schedule(labels, is_search, core):
    """The (i, j) index pairs to play, i < j: every pair, except a search
    bot against a non-search agent outside `core`."""
    todo = []
    n = len(labels)
    for i in range(n):
        for j in range(i + 1, n):
            si, sj = is_search[labels[i]], is_search[labels[j]]
            if si != sj and (labels[i] if sj else labels[j]) not in core:
                continue
            todo.append((i, j))
    return todo


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--games", type=int, default=100,
                    help="games per seat order per pair (total 2x)")
    ap.add_argument("--search-games", type=int, default=None,
                    help="per-order games for pairs with a search bot (default: --games)")
    ap.add_argument("--include-search", action="store_true",
                    help="add the search and censored-search rows (expensive)")
    ap.add_argument("--search-core", default="ppo_2b_h768,basic",
                    help="comma-list: search bots only play these roster members "
                         "(and each other)")
    ap.add_argument("--only-new", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    return ap


def main(argv=None, device="cuda") -> dict:
    """Play every pair the schedule gives that `--out` lacks, write the
    ladder and return its payload."""
    from ..device import resolve_device
    from ..ops import fused_actor_critic as fac
    from . import suite

    ap = build_parser()
    args = ap.parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(COMMITTED):
        ap.error(f"--out {args.out} is the JAX package's committed ladder, the reference "
                 f"this one is compared with; write another file")
    device = resolve_device(device)

    roster, policies, privileged = build_roster(args.include_search, device)
    labels = [label for label, _, _ in roster]
    is_search = {label: kind == "search" for label, kind, _ in roster}

    prior, prior_privileged = {}, {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            pj = json.load(f)
        prior = pj.get("pairs", {})
        prior_privileged = pj.get("privileged", {})
        print(f"[ladder] resuming: {len(prior)} pairs already done")

    pairs = dict(prior)  # never drop a measured pair
    # Labels only in prior pairs stay in the fit, with their prior flag, or
    # the known one, or privileged where neither says.
    extra_labels = sorted({l for k in prior for l in k.split(":")} - set(labels))
    dump_labels = labels + extra_labels
    privileged = {**prior_privileged, **privileged}
    for l in extra_labels:
        privileged.setdefault(l, KNOWN_PRIVILEGED.get(l, True))

    todo = schedule(labels, is_search, set(args.search_core.split(",")))
    launches_before, n_games, t_start = fac.launch_counts(), 0, time.perf_counter()
    for i, j in todo:
        key = f"{labels[i]}:{labels[j]}"
        if key in prior:
            continue
        g = args.games
        if is_search[labels[i]] or is_search[labels[j]]:
            g = args.search_games or args.games
        t0 = time.perf_counter()
        res = suite.head_to_head(policies[labels[i]], policies[labels[j]], g,
                                 seed=args.seed + 1000 * i + j, device=device)
        pairs[key] = res
        n_games += 2 * g
        print(f"[{len(pairs)}/{len(todo)}] {key}: {res['score']:.3f}±{res['score_ci95']:.3f} "
              f"({2 * g} games in {time.perf_counter() - t0:.2f} s)", flush=True)
        _dump(args.out, dump_labels, privileged, pairs, partial=True)

    secs = time.perf_counter() - t_start
    launches = {k: n - launches_before[k] for k, n in fac.launch_counts().items()}
    print(f"[ladder] {len(pairs) - len(prior)} pairs played, {n_games} games in {secs:.1f} s "
          f"({n_games / max(secs, 1e-9):.2f} games/s); kernel A launches {launches}", flush=True)
    payload = _dump(args.out, dump_labels, privileged, pairs, partial=False)
    print(f"wrote {args.out}")
    return payload


def score_table(pairs: dict, labels: list):
    """(score, games): a's points against b and the games they played, at
    [idx a, idx b] and the other way round, from every pair among `labels`."""
    import numpy as np

    idx = {l: i for i, l in enumerate(labels)}
    score = np.zeros((len(labels), len(labels)))
    games = np.zeros_like(score)
    for key, res in pairs.items():
        a, b = key.split(":")
        if a not in idx or b not in idx:
            continue
        i, j = idx[a], idx[b]
        pts = res["wins"] + 0.5 * res["draws"]
        score[i, j] += pts
        score[j, i] += res["n"] - pts
        games[i, j] += res["n"]
        games[j, i] += res["n"]
    return score, games


def _dump(out, labels, privileged, pairs, partial) -> dict:
    """Write the ladder's JSON (the JAX script's keys) and return it; the
    fit and its tables only when final."""
    import numpy as np

    payload = {"labels": labels, "privileged": privileged, "pairs": pairs, "partial": partial}
    if not partial:
        from .elo import bradley_terry_elo

        score, games = score_table(pairs, labels)
        played = games.sum(1) > 0
        sub = np.ix_(played, played)
        elo = bradley_terry_elo(score[sub], games[sub])
        rated = [l for l, p in zip(labels, played) if p]
        order = np.argsort(-elo)
        payload["elo"] = {rated[i]: float(elo[i]) for i in order}
        payload["score"] = score.tolist()
        payload["games"] = games.tolist()
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, out)
    return payload


if __name__ == "__main__":
    main()

"""Search-vs-search seat-averaged duels: flat MC, Gumbel, PUCT and their
censored variants against each other or the raw net.

Counterpart of `scripts/search_duel.py`, with the same bots, flags, tags,
printed line and JSON (`{f"{tag_a}_vs_{tag_b}": result}`): two bots over the
same trained net play `suite.head_to_head` (both seat orders on the same
deals, draws worth half a point).

Budgets: flat MC r8 h4 spends 45 * 8 = 360 playouts a move; Gumbel m16 k6 h4
spends log2(16) * 16 * 6 = 384 on the 16 sampled root actions; PUCT s64 runs
64 sequential tree simulations.

Bots (--a / --b): mc | gumbel | uct | greedy (the net's argmax) | cmc |
cgumbel (the information-set variants over determinized hidden cards).

Runs on the GPU; `main(argv, device="cpu")` runs it on the CPU.

Usage:
  python -m splendax_torch.eval.search_duel --npz runs/.../ppo_splendor_params.npz \
      --a gumbel --b mc --games 100
"""

from __future__ import annotations

import argparse
import json


def build(name: str, args, params):
    """(PolicySpec, tag) of bot `name` over `params` (None: heuristic
    leaves and uniform priors)."""
    from .. import search
    from . import suite

    if name == "mc":
        return (search.mc_search_policy(args.rollouts, args.horizon, params),
                f"mc(r{args.rollouts},h{args.horizon})")
    if name == "cmc":
        return (search.censored_mc_policy(args.rollouts, args.horizon, params),
                f"cmc(r{args.rollouts},h{args.horizon})")
    gf = getattr(args, "greedy_final", False)
    gtag = ",gf" if gf else ""
    if name in ("gumbel", "cgumbel"):
        make = search.gumbel_search_policy if name == "gumbel" else search.censored_gumbel_policy
        return (make(m=args.gumbel_m, k0=args.gumbel_k0, horizon=args.horizon, params=params,
                     c_scale=args.c_scale, greedy_final=gf),
                f"{name}(m{args.gumbel_m},k{args.gumbel_k0},h{args.horizon}{gtag})")
    if name == "uct":
        return search.uct_search_policy(args.sims, params=params), f"uct(s{args.sims})"
    if name == "greedy":
        if params is None:
            raise SystemExit("bot 'greedy' needs --npz (it IS the net)")
        return suite.model_greedy_policy(params), "greedy"
    raise SystemExit(f"unknown bot {name!r}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--npz", default=None, help="trained params for BOTH bots")
    ap.add_argument("--a", default="gumbel")
    ap.add_argument("--b", default="mc")
    ap.add_argument("--games", type=int, default=100,
                    help="games per seat order (total = 2x)")
    ap.add_argument("--rollouts", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=4)
    ap.add_argument("--gumbel-m", type=int, default=16)
    ap.add_argument("--gumbel-k0", type=int, default=6)
    ap.add_argument("--c-scale", type=float, default=10.0)
    ap.add_argument("--greedy-final", action="store_true",
                    help="gumbel/cgumbel: final argmax by q-hat alone (the default keeps "
                         "the paper's g+logits+sigma(q) rule)")
    ap.add_argument("--sims", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    return ap


def main(argv=None, device="cuda") -> dict:
    """Play the duel, print its line, write --json-out; returns the JSON."""
    from ..device import resolve_device
    from ..models.actor_critic import import_params_npz
    from . import suite

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    params = None
    if args.npz:
        params = import_params_npz(args.npz, device=device)
    else:
        print("[duel] no --npz: heuristic leaves / uniform priors")

    a, tag_a = build(args.a, args, params)
    b, tag_b = build(args.b, args, params)
    res = suite.head_to_head(a, b, args.games, seed=args.seed, device=device)
    priv = res["privileged"]
    ptag = ("" if not any(priv.values())
            else " [privileged: " + ",".join(k for k, v in priv.items() if v) + "]")
    print(f"{tag_a} vs {tag_b}: score={res['score']:.3f}"
          f"±{res['score_ci95']:.3f} W/D/L={res['wins']}/{res['draws']}/"
          f"{res['losses']} seat wins {res['first_seat']['a_wins']}/"
          f"{res['second_seat']['a_wins']} of {args.games}" + ptag)
    out = {f"{tag_a}_vs_{tag_b}": res}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json_out}")
    return out


if __name__ == "__main__":
    main()

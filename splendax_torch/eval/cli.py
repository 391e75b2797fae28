"""Evaluation CLI, one subcommand per match-up.

Counterpart of `splendax/eval/cli.py`, with the same subcommands, flags,
printed lines and JSON:

  vs-random        the model (sampling with --stochastic) against random
  vs-basic         the greedy model against the basic-priority heuristic
  basic-vs-model   the same with the seats swapped
  bots             pairwise matches between named heuristics
  vs-noble         the model against the noble-rush heuristic
  vs-model         model against model (--opp-npz / --opp-torch-pt)
  suite            the model against random / greedy_v1 / basic / itself
  pool-elo         round-robin of the pool snapshots inside a training
                   checkpoint with a Bradley-Terry / Elo fit (`eval/elo.py`)
  vs-search        the model (or an --agent heuristic) against a search bot:
                   --algo mc (flat Monte-Carlo, --rollouts / --horizon), uct
                   (PUCT tree search, --sims), gumbel (sequential halving,
                   --gumbel-m / --gumbel-k0 / --horizon), or cmc / cgumbel,
                   the censored variants over determinized hidden
                   information; --search-npz gives the search a trained net
                   for its priors and leaf values

Checkpoints: --npz (the params export of either package) or --torch-pt (an
`ActorCritic.state_dict()` saved with `torch.save`, weights [out, in]).
Random initial params are used if neither is given.  --checkpoint names a
training checkpoint, `<log_dir>/ppo_splendor_latest.pt`.

Like the train CLI it has no device flag and runs on the GPU.

Usage: python -m splendax_torch.eval.cli <subcommand> [--games N] ...
"""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device

COMMANDS = ["vs-random", "vs-basic", "basic-vs-model", "bots", "vs-noble", "vs-model", "suite",
            "pool-elo", "vs-search"]


def _load_params(args, device):
    from ..models import actor_critic as ac

    if getattr(args, "npz", None):
        return ac.import_params_npz(args.npz, device=device)
    if getattr(args, "torch_pt", None):
        sd = torch.load(args.torch_pt, map_location="cpu", weights_only=True)
        model = ac.ActorCritic(int(sd["actor.0.weight"].shape[0]), device=device)
        model.load_state_dict(sd)
        return model
    print("[eval] no checkpoint given; using random-init params")
    gen = torch.Generator(device=device).manual_seed(0)
    return ac.ActorCritic(256, gen, device)


def _priv_tag(res):
    """' [privileged: ...]' when either side reads the full GameState:
    privileged and observation-only agents are different weight classes."""
    p = res.get("privileged")
    if not p or not any(p.values()):
        return ""
    return " [privileged: " + ",".join(k for k, v in p.items() if v) + "]"


def _print(name, res):
    if "score" in res:  # the seat-averaged head_to_head dict
        print(f"{name}: score={res['score']:.3f}±{res['score_ci95']:.3f} "
              f"W/D/L={res['wins']}/{res['draws']}/{res['losses']} "
              f"seat wins {res['first_seat']['a_wins']}/"
              f"{res['second_seat']['a_wins']} of {res['n'] // 2}"
              + _priv_tag(res))
        return
    print(f"{name}: wr={res['win_rate']:.3f}±{res['win_rate_ci95']:.3f} "
          f"W/D/L={res['wins']}/{res['draws']}/{res['losses']} "
          f"avg_turns={res['avg_turns']:.2f} avg_prestige={res['avg_prestige']:.2f} "
          f"illegal={res['illegal_action_rate']:.4f}" + _priv_tag(res))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("command", choices=COMMANDS)
    ap.add_argument("--checkpoint", default=None,
                    help="pool-elo: training checkpoint file "
                         "(e.g. <log_dir>/ppo_splendor_latest.pt)")
    ap.add_argument("--algo", default="mc", choices=["mc", "uct", "gumbel", "cmc", "cgumbel"],
                    help="vs-search: flat Monte-Carlo, PUCT tree search, or Gumbel "
                         "sequential-halving root search; cmc/cgumbel are the censored "
                         "(information-set) variants over determinized hidden info")
    ap.add_argument("--sims", type=int, default=64,
                    help="vs-search --algo uct: tree simulations per move")
    ap.add_argument("--gumbel-m", type=int, default=16,
                    help="vs-search --algo gumbel: root candidates (power of two)")
    ap.add_argument("--gumbel-k0", type=int, default=6,
                    help="vs-search --algo gumbel: round-0 playouts per candidate "
                         "(total budget = log2(m)*m*k0)")
    ap.add_argument("--greedy-final", action="store_true",
                    help="gumbel/cgumbel: final argmax by q-hat alone "
                         "(exploitative acting; default = paper rule)")
    ap.add_argument("--rollouts", type=int, default=8,
                    help="vs-search: playouts per root action")
    ap.add_argument("--horizon", type=int, default=24,
                    help="vs-search: random-playout depth in plies")
    ap.add_argument("--search-npz", default=None,
                    help="vs-search: critic .npz for leaf evaluation "
                         "(default: prestige-lead heuristic)")
    ap.add_argument("--agent", default=None,
                    help="vs-search: heuristic agent name instead of a model "
                         "(random/greedy_v1/basic/greedy_v2/noble)")
    ap.add_argument("--games", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--npz", default=None, help="params .npz")
    ap.add_argument("--torch-pt", default=None, help="ActorCritic state_dict .pt")
    ap.add_argument("--opp-npz", default=None, help="vs-model opponent: params .npz")
    ap.add_argument("--opp-torch-pt", default=None,
                    help="vs-model opponent: ActorCritic state_dict .pt")
    ap.add_argument("--stochastic", action="store_true",
                    help="sample instead of greedy argmax (vs-random default)")
    ap.add_argument("--both-seats", action="store_true",
                    help="vs-model / vs-search / vs-basic: play --games per seat order and "
                         "report the seat-averaged score (suite.head_to_head): first-mover "
                         "advantage is large, so strength claims need this")
    ap.add_argument("--pairs", nargs="*", default=["basic:greedy_v1"],
                    help="bot pairs left:right for `bots`")
    ap.add_argument("--json-out", default=None)
    return ap


def _search_policy(args, leaf):
    """(PolicySpec, tag) of the search bot that `vs-search` plays against."""
    from .. import search

    if args.algo == "uct":
        return search.uct_search_policy(args.sims, params=leaf), f"uct(s{args.sims})"
    if args.algo in ("gumbel", "cgumbel"):
        make = (search.gumbel_search_policy if args.algo == "gumbel"
                else search.censored_gumbel_policy)
        spec = make(m=args.gumbel_m, k0=args.gumbel_k0, horizon=args.horizon, params=leaf,
                    greedy_final=args.greedy_final)
        return spec, f"{args.algo}(m{args.gumbel_m},k{args.gumbel_k0},h{args.horizon})"
    make = search.censored_mc_policy if args.algo == "cmc" else search.mc_search_policy
    return make(args.rollouts, args.horizon, leaf), f"{args.algo}(r{args.rollouts},h{args.horizon})"


def main(argv=None, device="cuda") -> dict:
    """Run the subcommand, print its lines, write --json-out; returns what
    --json-out holds."""
    from . import suite

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.command == "pool-elo" and not args.checkpoint:
        ap.error("pool-elo requires --checkpoint <training checkpoint .pt>")
    device = resolve_device(device)

    def vs(a, b):
        return suite.eval_vs_opponent(a, b, args.games, args.seed, device=device)

    results = {}
    if args.command == "bots":
        pairs = [tuple(p.split(":")) for p in args.pairs]
        results = suite.bot_round_robin(pairs, args.games, args.seed, device=device)
    elif args.command == "pool-elo":
        from .elo import load_pool_stack, pool_round_robin

        stack, n, labels = load_pool_stack(args.checkpoint)
        league = pool_round_robin(stack, n, args.games, args.seed, labels, device=device)
        print(f"pool league ({n} entries, {args.games} games/ordered pair):")
        for name, rating in league["elo"].items():
            print(f"  {name:>10s}  Elo {rating:7.1f}")
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(league, f, indent=2)
            print(f"wrote {args.json_out}")
        return league
    else:
        from ..models.actor_critic import import_params_npz

        params = _load_params(args, device)
        model = (suite.model_sampling_policy(params) if args.stochastic
                 else suite.model_greedy_policy(params))

        def matchup(a, b):
            if args.both_seats:
                return suite.head_to_head(a, b, args.games, args.seed, device=device)
            return vs(a, b)

        if args.command == "vs-random":
            results["model_vs_random"] = vs(model, suite.heuristic_policy("random"))
        elif args.command == "vs-basic":
            results["model_vs_basic"] = matchup(model, suite.heuristic_policy("basic"))
        elif args.command == "basic-vs-model":
            results["basic_vs_model"] = vs(suite.heuristic_policy("basic"), model)
        elif args.command == "vs-noble":
            results["model_vs_noble"] = vs(model, suite.heuristic_policy("noble"))
        elif args.command == "vs-model":
            opp_args = argparse.Namespace(npz=args.opp_npz, torch_pt=args.opp_torch_pt)
            opp = suite.model_greedy_policy(_load_params(opp_args, device))
            results["model_vs_model"] = matchup(model, opp)
        elif args.command == "vs-search":
            leaf = import_params_npz(args.search_npz, device=device) if args.search_npz else None
            search, tag = _search_policy(args, leaf)
            agent = suite.heuristic_policy(args.agent) if args.agent else model
            results[f"{args.agent or 'model'}_vs_{tag}"] = matchup(agent, search)
        elif args.command == "suite":
            results = suite.run_evaluation_suite(params, args.games, args.seed, device=device)

    for name, res in results.items():
        _print(name, res)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {args.json_out}")
    return results


if __name__ == "__main__":
    main()

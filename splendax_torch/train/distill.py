"""Search distillation: one AlphaZero-style policy-improvement iteration.

Counterpart of `splendax/train/distill.py`, with the same phases, dataset,
targets, gate and CLI:

1. **Generate**: self-play games where both seats play the argmax of the
   flat-MC search's root Q-values over the current net (`search.mc`, or the
   information-set teacher `search.ismc` with `--censored`): actor-guided
   playouts, critic leaves, exact terminal values.  Every ply records the
   mover's (obs, mask, root Q-values, root actor logits, search argmax) and,
   once the game is over, its realized outcome from the mover's side.
2. **Distill**: a supervised fine-tune of the same net: cross-entropy of the
   masked actor toward a target built from the root Q-values (`gumbel`, the
   default: softmax(actor_logits + c * q), which keeps the net's prior;
   `soft`: softmax(q / tau); `hard`: the argmax), and MSE of the critic
   toward the realized outcome.
3. **Gate** (`--gate-games`): the candidate replaces the incumbent only if
   it beats it over seat-averaged paired deals with a CI that excludes 0.5.

Generation is a Python loop over plies on the device, as the port's rollout
and searches are; each ply runs the teacher, the argmax, the root prior, the
optional sampled move, the record and the engine step, with finished games
frozen.  Every forward of generation and of the gate runs the fused
actor-critic kernel: per ply `horizon` playout moves without value and one
leaf batch with value on B x 45 x rollouts lanes, and the root prior on B
rows.  The prior is the raw actor head, as the JAX package records it: the
kernel is called with an all-true mask, and a row with every action legal
comes out unmasked.  The fit differentiates the plain forward
(`ActorCritic.forward`) under autograd in float32, TF32 left off as in the
learner, and steps through `train.optim` (clip 0.5, Adam eps 1e-5).

Random inputs come from a `torch.Generator`: the deals, the searches' draws
and the sampled plies' Gumbel noise.  `_generate` takes each of them from
the caller instead (`state0=`, `draws=`, `noise=`), and `play=` plays given
actions while the port's own Q-values and argmax are recorded, so a test
can hold the loop against the JAX package ply by ply.

CLI:  python -m splendax_torch.train.distill --npz <params.npz> --out <dir>
(on the card; `main(argv, device="cpu")` runs it on the CPU).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..engine import rules as R
from ..engine.encode import encode_observation
from ..env import core
from ..env.core import select
from ..models import actor_critic as ac
from ..ops.fused_actor_critic import fused_masked_forward, masked_logits
from ..search.ismc import censored_mc_q
from ..search.mc import as_ctx, mc_search_q
from . import optim

_NEG = -float("inf")
A = R.TOTAL_ACTIONS


# --------------------------------------------------------------------------
# Phase 1: self-play data generation under the search policy.
# --------------------------------------------------------------------------

@torch.no_grad()
def _generate(params, generator, n_games: int, rollouts: int, horizon: int, max_plies: int,
              rng_mode: str = "fast", guided: bool = True, sample_plies: int = 0,
              c_scale: float = 10.0, censored: bool = False, *, state0=None, draws=None,
              noise=None, play=None):
    """`n_games` self-play games of `max_plies` plies under the search
    policy -> (data of device tensors [P, B, ...], stats of device scalars).

    `params` is an `ActorCritic` or its kernel weights.  Hooks, each indexed
    by ply: `draws[p]` the teacher's random inputs (`mc_search_q`'s or
    `censored_mc_q`'s `draws=`), `noise[p]` the Gumbel noise f32 [B, 45] of
    a sampled ply, `play[p]` the actions to play; `state0` the deals."""
    make_q = censored_mc_q if censored else mc_search_q
    q_fn = make_q(rollouts=rollouts, horizon=horizon, rng_mode=rng_mode, guided=guided)
    ctx = as_ctx(params)
    dev = ctx[0].device
    B = n_games
    if state0 is None:
        state, obs, mask = core.reset(B, generator, dev)
    else:
        state, obs, mask = state0, encode_observation(state0), R.legal_mask(state0)
    every = torch.ones((B, A), dtype=torch.bool, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    recs = []
    for ply in range(max_plies):
        q = q_fn(ctx, obs, mask, state, generator, None if draws is None else draws[ply])
        a = torch.argmax(q, dim=-1)
        logits, _ = fused_masked_forward(ctx, obs, every, with_value=False)  # the raw head
        if play is not None:
            a_play = play[ply]
        elif ply < sample_plies:
            # Opening diversity (AlphaZero's temperature moves): the PLAYED
            # action samples the improved policy softmax(logits + c * q), the
            # distribution the gumbel target distills; the recorded action
            # stays the search argmax.
            scores = torch.where(mask, logits + c_scale * torch.where(mask, q, 0.0), _NEG)
            g = ac.gumbel_noise(scores.shape, generator, dev) if noise is None else noise[ply]
            a_play = torch.argmax(scores + g, dim=-1)
        else:
            a_play = a
        # Recorded before the step: obs is already the mover's encode.
        recs.append((obs, mask, q, logits, a, state.to_play, active & mask.any(-1)))
        nxt, _ = core.step_core(state, a_play, rng_mode=rng_mode, mask=mask)
        state = select(active, nxt, state)  # a finished game stays as it is
        obs = select(active, encode_observation(state), obs)
        mask = select(active, R.legal_mask(state), mask)
        active = active & ~R.is_terminal(state)

    obs_t, mask_t, q_t, logits_t, act_t, mover_t, live_t = (torch.stack(x) for x in zip(*recs))
    # Outcome targets: the realized final reward from the mover's side (win
    # +1, loss -1, draw 0, turn-limit draw -0.1).
    fr = core.final_rewards_of(state)  # [B, 2]
    finished = R.is_terminal(state)
    z = torch.where(mover_t == 0, fr[None, :, 0], fr[None, :, 1])
    weight = (live_t & finished[None, :]).to(torch.float32)
    data = {
        "obs": obs_t,  # [P, B, 297] int32, mover's view
        "mask": mask_t,  # [P, B, 45] bool
        "q": q_t,  # [P, B, 45] f32 root search values (-inf illegal)
        "logits": logits_t,  # [P, B, 45] f32 root actor prior (unmasked)
        "action": act_t.to(torch.int32),  # [P, B] search argmax
        "z": z,  # [P, B] f32 realized outcome, mover's side
        "weight": weight,  # [P, B] f32 1.0 for usable samples
    }
    n_finished = finished.sum()
    stats = {
        "n_samples": weight.sum(),
        "games_finished": n_finished,
        "avg_turns": torch.where(finished, state.turn_count, 0).sum() / n_finished.clamp(min=1),
    }
    return data, stats


def generate_search_games(params, generator, n_games: int, rollouts: int = 8, horizon: int = 4,
                          max_plies: int = 120, rng_mode: str = "fast", guided: bool = True,
                          sample_plies: int = 0, c_scale: float = 10.0, gen_batch: int = 0,
                          drop_dead: bool = False, verbose: bool = False,
                          censored: bool = False) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Self-play `n_games` with search on both seats; returns the flattened
    dataset on the host and the generation stats.

    Plies past a game's end carry weight 0, as do games still unfinished at
    `max_plies` (their outcome target would be undefined).  `gen_batch` > 0
    generates in chunks of that many games (the search holds B x 45 x
    rollouts lane states: at B=1024 and 16 rollouts, 737,280 of them);
    `drop_dead` keeps only the weighted rows."""
    chunk = gen_batch if gen_batch > 0 else n_games
    flats, n_samples, games_finished, turns_sum = [], 0.0, 0.0, 0.0
    for i, start in enumerate(range(0, n_games, chunk)):
        b = min(chunk, n_games - start)
        data, stats = _generate(params, generator, b, rollouts, horizon, max_plies, rng_mode,
                                guided, sample_plies, c_scale, censored)
        flat = {k: v.cpu().numpy().reshape((-1,) + tuple(v.shape[2:])) for k, v in data.items()}
        if drop_dead:
            keep = flat["weight"] > 0
            flat = {k: v[keep] for k, v in flat.items()}
        flats.append(flat)
        s = {k: float(v) for k, v in stats.items()}
        n_samples += s["n_samples"]
        games_finished += s["games_finished"]
        turns_sum += s["avg_turns"] * s["games_finished"]
        if verbose:
            print(f"  chunk {i}: {b} games, {s['n_samples']:.0f} samples")
    flat = {k: np.concatenate([f[k] for f in flats]) for k in flats[0]}
    return flat, {
        "n_samples": n_samples,
        "games_finished": games_finished,
        "avg_turns": turns_sum / max(1.0, games_finished),
    }


# --------------------------------------------------------------------------
# Phase 2: supervised fine-tune toward the search targets.
# --------------------------------------------------------------------------

def build_targets(data: Dict[str, np.ndarray], target: str = "gumbel", c_scale: float = 10.0,
                  tau: float = 0.2) -> np.ndarray:
    """Per-sample target distribution [N, 45] over legal actions.

    - ``gumbel`` (default): softmax(actor_logits + c_scale * q), the
      Gumbel-MuZero root policy-improvement transform; prior-preserving.
    - ``soft``: softmax(q / tau), search-only, prior-free.
    - ``hard``: one-hot of the search argmax.
    """
    mask = np.asarray(data["mask"], bool)
    if target == "hard":
        t = np.zeros(mask.shape, np.float32)
        t[np.arange(mask.shape[0]), data["action"]] = 1.0
        return t
    # q is -inf on illegal actions; zero it there (the mask kills those slots
    # below) so c_scale * q cannot make 0 * -inf = NaN.
    q = np.where(mask, np.asarray(data["q"], np.float32), 0.0)
    if target == "gumbel":
        scores = np.asarray(data["logits"], np.float32) + c_scale * q
    elif target == "soft":
        scores = q / tau
    else:
        raise ValueError(f"unknown target mode {target!r}")
    scores = np.where(mask, scores, -1e9)
    scores -= scores.max(-1, keepdims=True)
    e = np.exp(scores)
    return (e / np.maximum(e.sum(-1, keepdims=True), 1e-9)).astype(np.float32)


def _distill_loss(model: ac.ActorCritic, value_coef: float, obs, mask, tgt, action, z, weight):
    """Weighted CE toward `tgt` plus `value_coef` x the critic's MSE ->
    (loss, (ce, v_loss, agreement with the search argmax))."""
    logits, value = model(obs)
    logp = torch.log_softmax(masked_logits(logits, mask), dim=-1)
    denom = weight.sum().clamp(min=1.0)
    ce = -(weight * (tgt * logp).sum(-1)).sum() / denom
    v_loss = (weight * (value - z) ** 2).sum() / denom
    agree = (weight * (ac.greedy_action(logits.detach(), mask) == action)).sum() / denom
    return ce + value_coef * v_loss, (ce.detach(), v_loss.detach(), agree)


def _distill_epoch(model, opt_state, data, perm, minibatch: int, value_coef: float, lr: float):
    """One pass over `perm` in whole minibatches (the remainder is dropped),
    each a clipped Adam step in place on `model` -> the mean metrics as
    device scalars."""
    n_mb = perm.shape[0] // minibatch
    params = list(model.parameters())
    metrics = []
    for idx in perm[: n_mb * minibatch].reshape(n_mb, minibatch):
        batch = [data[k][idx] for k in ("obs", "mask", "tgt", "action", "z", "weight")]
        loss, aux = _distill_loss(model, value_coef, *batch)
        grads = torch.autograd.grad(loss, params)
        optim.step(params, grads, opt_state, lr)
        metrics.append(torch.stack((loss.detach(),) + aux))
    m = torch.stack(metrics).mean(0)
    return dict(zip(("loss", "ce", "v_loss", "agreement"), m))


def distill_fit(params: ac.ActorCritic, data: Dict[str, np.ndarray], epochs: int = 3,
                minibatch: int = 4096, lr: float = 1e-4, value_coef: float = 0.5, seed: int = 0,
                verbose: bool = False, target: str = "gumbel", c_scale: float = 10.0,
                tau: float = 0.2):
    """Fine-tune a copy of `params` on a generated search dataset.  Returns
    the new model and the per-epoch metric history (ce, v_loss and agreement
    are means over the minibatches taken).  `agreement` is always against
    the search argmax, whatever the target transform.  The minibatch order
    is `np.random.default_rng(seed).permutation(n)`, one per epoch."""
    n = data["obs"].shape[0]
    if n == 0 or float(np.asarray(data["weight"]).sum()) == 0.0:
        raise ValueError(
            "distill_fit: dataset has no usable samples (weight.sum() == 0): no game "
            "finished within max_plies; fitting would write an unchanged checkpoint "
            "labeled 'distilled'"
        )
    minibatch = min(minibatch, n)
    model = copy.deepcopy(params)
    dev = next(model.parameters()).device
    dev_data = {
        "obs": torch.as_tensor(np.asarray(data["obs"], np.float32), device=dev),
        "mask": torch.as_tensor(np.asarray(data["mask"], bool), device=dev),
        "tgt": torch.as_tensor(build_targets(data, target, c_scale, tau), device=dev),
        "action": torch.as_tensor(np.asarray(data["action"], np.int64), device=dev),
        "z": torch.as_tensor(np.asarray(data["z"], np.float32), device=dev),
        "weight": torch.as_tensor(np.asarray(data["weight"], np.float32), device=dev),
    }
    opt_state = optim.init(model.parameters())
    history = []
    rng = np.random.default_rng(seed)
    for e in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=dev)
        m = _distill_epoch(model, opt_state, dev_data, perm, minibatch, value_coef, lr)
        m = {k: float(v) for k, v in m.items()}
        history.append(m)
        if verbose:
            print(f"epoch {e}: {json.dumps(m)}")
    return model, history


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def gate_passes(h2h: dict, gate_min: float) -> bool:
    """Promotion gate: score >= gate_min AND the gate's own CI excludes 0.50.

    A threshold inside the CI is decoration: requiring score - ci > 0.5
    makes a pass mean "better than the incumbent at 95%" wherever gate_min
    sits.  With paired mirrored deals (`eval.suite.head_to_head`) a
    candidate identical to the incumbent scores exactly 0.500 +- 0 and can
    never pass."""
    return (h2h["score"] >= gate_min) and (h2h["score"] - h2h["score_ci95"] > 0.5)


def main(argv=None, device="cuda"):
    device = resolve_device(device)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--npz", required=True, help="params npz to improve")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--games", type=int, default=1024,
                   help="self-play games generated per iteration")
    p.add_argument("--gen-batch", type=int, default=1024,
                   help="games per generation chunk (device memory bound)")
    p.add_argument("--rollouts", type=int, default=8)
    p.add_argument("--horizon", type=int, default=4)
    p.add_argument("--max-plies", type=int, default=120)
    p.add_argument("--sample-plies", type=int, default=0,
                   help="plies per game whose PLAYED action samples the "
                        "improved policy instead of argmax (opening "
                        "diversity; AlphaZero's temperature moves)")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--fit-samples", type=int, default=0,
                   help="if >0, subsample the dataset to exactly this many "
                        "rows (the same epoch shapes in every iteration)")
    p.add_argument("--minibatch", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--value-coef", type=float, default=0.5)
    p.add_argument("--target", choices=("gumbel", "soft", "hard"), default="gumbel")
    p.add_argument("--c-scale", type=float, default=10.0,
                   help="Q-to-logit scale for the gumbel target")
    p.add_argument("--tau", type=float, default=0.2,
                   help="temperature for the soft target")
    p.add_argument("--censored", action="store_true",
                   help="use the information-set teacher (search/ismc.py): "
                        "search Q-values over determinized hidden info, so "
                        "targets are a function of the mover's information set")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=1,
                   help="generate->fit->gate iterations (AlphaZero loop)")
    p.add_argument("--gate-games", type=int, default=0,
                   help="if >0, seat-averaged head-to-head games (per order) "
                        "of each candidate vs the incumbent; the candidate "
                        "is promoted only if score >= --gate-min AND the "
                        "gate CI excludes 0.50 (gate_passes)")
    p.add_argument("--gate-min", type=float, default=0.55,
                   help="min seat-averaged score to promote a candidate")
    p.add_argument("--eval-games", type=int, default=0,
                   help="if >0, final seat-averaged eval of the result vs "
                        "the original net and vs basic_priority")
    p.add_argument("--save-data", default=None,
                   help="npz path to dump the generated dataset (iter 0)")
    p.add_argument("--load-data", default=None,
                   help="npz dataset to fit on instead of generating "
                        "(controlled fit-hyperparameter ablations; iters=1)")
    args = p.parse_args(argv)

    from ..eval import suite

    params0 = ac.import_params_npz(args.npz, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    os.makedirs(args.out, exist_ok=True)

    config = {k: getattr(args, k) for k in
              ("games", "gen_batch", "rollouts", "horizon", "max_plies",
               "sample_plies", "epochs", "minibatch", "lr", "value_coef",
               "target", "c_scale", "tau", "seed", "iters", "gate_games",
               "gate_min", "censored")}

    def dump(results):
        # Incremental: an iteration cut short must not lose the gate history
        # of the iterations already measured.
        with open(os.path.join(args.out, "results.json"), "w") as f:
            json.dump(results, f, indent=2)

    incumbent = params0
    iterations = []
    for it in range(args.iters):
        rec = {"iter": it}
        if args.load_data and it == 0:
            with np.load(args.load_data) as loaded:
                data = {k: loaded[k] for k in loaded.files if k != "_stats"}
                stats = json.loads(str(loaded["_stats"]))
            print(f"loaded dataset {args.load_data}: {json.dumps(stats)}")
        else:
            teacher = "censored-mc" if args.censored else "mc"
            print(f"[iter {it}] generating {args.games} {teacher} self-play "
                  f"games (r{args.rollouts} h{args.horizon}, <= "
                  f"{args.max_plies} plies, sample first {args.sample_plies}) "
                  "...")
            data, stats = generate_search_games(
                incumbent, generator, args.games,
                rollouts=args.rollouts, horizon=args.horizon,
                max_plies=args.max_plies, sample_plies=args.sample_plies,
                c_scale=args.c_scale, gen_batch=args.gen_batch,
                drop_dead=True, verbose=True, censored=args.censored,
            )
            print(f"[iter {it}] dataset: {json.dumps(stats)}")
            if args.save_data and it == 0:
                np.savez_compressed(args.save_data, _stats=json.dumps(stats), **data)
                print(f"saved dataset to {args.save_data}")
        rec["generation"] = stats
        n_rows = data["obs"].shape[0]
        if 0 < args.fit_samples < n_rows:
            sub = np.random.default_rng(args.seed + it).choice(
                n_rows, args.fit_samples, replace=False)
            data = {k: v[sub] for k, v in data.items()}
            print(f"[iter {it}] subsampled {n_rows} -> {args.fit_samples} rows")
        elif args.fit_samples > n_rows:
            print(f"[iter {it}] WARNING: only {n_rows} rows "
                  f"(< --fit-samples {args.fit_samples}); epoch program "
                  f"shape will differ this iteration")

        candidate, history = distill_fit(
            incumbent, data, epochs=args.epochs, minibatch=args.minibatch,
            lr=args.lr, value_coef=args.value_coef, seed=args.seed + it,
            verbose=True, target=args.target, c_scale=args.c_scale,
            tau=args.tau,
        )
        rec["fit_history"] = history

        if args.gate_games > 0:
            h2h = suite.head_to_head(
                suite.model_greedy_policy(candidate),
                suite.model_greedy_policy(incumbent),
                args.gate_games, seed=args.seed + 100 * (it + 1), device=device,
            )
            promoted = gate_passes(h2h, args.gate_min)
            rec["gate"] = h2h
            print(f"[iter {it}] gate: candidate vs incumbent "
                  f"score={h2h['score']:.3f}±{h2h['score_ci95']:.3f} "
                  f"(seat wins {h2h['first_seat']['a_wins']}/"
                  f"{h2h['second_seat']['a_wins']} of {args.gate_games}) -> "
                  f"{'PROMOTED' if promoted else 'rejected'}")
        else:
            promoted = True
        rec["promoted"] = bool(promoted)
        if promoted:
            incumbent = candidate
        iterations.append(rec)
        dump({"iterations": iterations, "source_npz": args.npz,
              "accepted": sum(r["promoted"] for r in iterations),
              "config": config, "partial": True})

    new_params = incumbent
    out_npz = os.path.join(args.out, "distilled_params.npz")
    ac.export_params_npz(new_params, out_npz)
    results = {"iterations": iterations, "source_npz": args.npz,
               "accepted": sum(r["promoted"] for r in iterations),
               "config": config}

    if args.eval_games > 0:
        print(f"final eval over {args.eval_games} games/order ...")
        results["distilled_vs_original"] = suite.head_to_head(
            suite.model_greedy_policy(new_params),
            suite.model_greedy_policy(params0),
            args.eval_games, seed=args.seed + 10_000, device=device,
        )
        # +20_000 keeps this matchup's deals disjoint from
        # distilled_vs_original's (+10_000), so the two CIs are independent.
        results["distilled_vs_basic"] = suite.head_to_head(
            suite.model_greedy_policy(new_params),
            suite.heuristic_policy("basic"),
            args.eval_games, seed=args.seed + 20_000, device=device,
        )
        for k in ("distilled_vs_original", "distilled_vs_basic"):
            r = results[k]
            print(f"{k}: score={r['score']:.3f}±{r['score_ci95']:.3f} "
                  f"(seat wins {r['first_seat']['a_wins']}/"
                  f"{r['second_seat']['a_wins']} of {args.eval_games})")

    dump(results)
    print(f"wrote {out_npz} ({results['accepted']}/{args.iters} promoted)")


if __name__ == "__main__":
    main()

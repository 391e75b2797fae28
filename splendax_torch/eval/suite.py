"""Evaluation suite: lockstep matches on whole batches.

Counterpart of `splendax/eval/suite.py`.  All `n_games` of a match run in
lockstep on `dual.dual_step`, the agent as player 0, for at most
`TURN_LIMIT` turns; the loop ends as soon as no game is still active, which
changes no result.  The statistics are those of the JAX package: win rate
with +-1.96 sqrt(p (1 - p) / n), average turns, average prestige of the last
mover, illegal-action rate, and the random / greedy_v1 / basic / self roster
of `run_evaluation_suite`.

A policy is a `(fn, ctx)` pair with `fn(ctx, obs, mask, state, generator) ->
action int64 [B]` on the whole batch; for a network `ctx` holds its weights
in the fused forward's layout, and the forward runs the fused actor-critic
kernel.

Outcomes are counted from the final rewards (win: > 0, loss: < 0, so a
turn-limit draw at -0.1 counts as a loss), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..engine import rules
from ..engine.encode import encode_observation
from ..engine.state import TURN_LIMIT, GameState
from ..env import core
from ..models import actor_critic as ac
from ..ops.fused_actor_critic import PreparedWeights, fused_masked_forward
from ..selfplay import dual
from ..selfplay.opponents import DEVICE_POLICIES

PolicySpec = Tuple[Callable, object]


def _greedy_model_fn(weights, obs, mask, state, generator):
    """Argmax of the masked logits (the kernel returns them masked)."""
    logits, _ = fused_masked_forward(weights, obs, mask, with_value=False)
    return torch.argmax(logits, dim=-1)


def _sampling_model_fn(weights, obs, mask, state, generator):
    """A sample from the masked categorical."""
    logits, _ = fused_masked_forward(weights, obs, mask, with_value=False)
    return ac.sample_action(logits, mask, generator=generator)[0]


def is_privileged(policy: PolicySpec) -> bool:
    """True if the policy reads the full GameState rather than only the
    observation; policy functions declare it with a `privileged = True`
    attribute (greedy_v2).  Every result dict carries the flag for both
    sides: the two are different weight classes."""
    return bool(getattr(policy[0], "privileged", False))


def model_greedy_policy(params: ac.ActorCritic) -> PolicySpec:
    """The greedy policy of `params`; its weights a handle, prepared once
    for all the games it plays."""
    return (_greedy_model_fn, PreparedWeights(ac.kernel_weights(params)))


def model_sampling_policy(params: ac.ActorCritic) -> PolicySpec:
    return (_sampling_model_fn, PreparedWeights(ac.kernel_weights(params)))


_HEURISTIC_FNS: Dict[str, Callable] = {}


def heuristic_policy(name: str) -> PolicySpec:
    if name not in _HEURISTIC_FNS:
        if name not in DEVICE_POLICIES:  # registered when its module is imported
            from . import noble  # noqa: F401
        heuristic = DEVICE_POLICIES[name]

        def fn(ctx, obs, mask, state, generator):
            return heuristic(obs, mask, state, generator)

        fn.__name__ = f"heuristic_{name}"
        fn.privileged = is_privileged((heuristic, None))
        _HEURISTIC_FNS[name] = fn
    return (_HEURISTIC_FNS[name], None)


@torch.no_grad()
def _play_matches(agent_fn, agent_ctx, opp_fn, opp_ctx, n_games: int, generator,
                  rng_mode: str = "fast", state: Optional[GameState] = None):
    """Play n_games to their end (agent = player 0) on the generator's
    device, from fresh deals unless `state` gives the games to start from.
    Returns per-game (final_reward0, turn_count, prestige_last_mover,
    illegal, checks, active)."""
    dev = generator.device
    if state is None:
        state, obs, mask = core.reset(n_games, generator, dev)
    else:
        obs, mask = encode_observation(state), rules.legal_mask(state)
    active = torch.ones(n_games, dtype=torch.bool, device=dev)
    illegal = torch.zeros(n_games, dtype=torch.int32, device=dev)
    checks = torch.zeros(n_games, dtype=torch.int32, device=dev)
    final_r = torch.zeros(n_games, dtype=torch.float32, device=dev)

    def opp_policy(obs, mask, state):
        return opp_fn(opp_ctx, obs, mask, state, generator)

    def keep(new, old):
        return torch.where(active.view((-1,) + (1,) * (old.dim() - 1)), new, old)

    # A full game is at most TURN_LIMIT complete turns.
    for _ in range(TURN_LIMIT):
        with trace.span("eval.turn"):
            a = agent_fn(agent_ctx, obs, mask, state, generator)
            # Not given `mask`: a finished game keeps an all-False one, and
            # the opponent still sees its ply from the state's own mask.
            next_state, out = dual.dual_step(state, a, opp_policy, rng_mode)
            checks = checks + active
            illegal = illegal + (active & out.illegal_agent)
            final_r = torch.where(active & out.done, out.agent_reward, final_r)
            state = GameState(**{k: keep(getattr(next_state, k), v) for k, v in state.items()})
            obs, mask = keep(out.agent_obs, obs), keep(out.action_mask, mask)
            active = active & ~out.done
            playing = trace.sync("eval.active", active.any().item)
        if not playing:
            break
    last_mover = (state.to_play.long() - 1) % 2
    prestige = state.prestige.gather(1, last_mover[:, None])[:, 0]
    return final_r, state.turn_count, prestige, illegal, checks, active


def summarize(final_r, turns, prestige, illegal, checks) -> Dict:
    """The stats dict of one match from its per-game arrays."""
    final_r, turns, prestige, illegal, checks = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (final_r, turns, prestige, illegal, checks))
    n = len(final_r)
    wins = int((final_r > 0).sum())
    losses = int((final_r < 0).sum())
    p = wins / max(1, n)
    return {
        "n": n,
        "wins": wins,
        "losses": losses,
        "draws": n - wins - losses,
        "win_rate": p,
        "win_rate_ci95": 1.96 * np.sqrt(p * (1 - p) / max(1, n)),
        "avg_turns": float(np.mean(turns)),
        "avg_prestige": float(np.mean(prestige)),
        "illegal_action_rate": float(illegal.sum() / max(1, checks.sum())),
    }


def _match(p0: PolicySpec, p1: PolicySpec, n_games: int, seed: int, rng_mode: str, device):
    """One match from the deals of `seed`; the per-game arrays on the host."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    *arrays, still_active = _play_matches(p0[0], p0[1], p1[0], p1[1], n_games, gen, rng_mode)
    arrays, still_active = trace.sync(
        "eval.result", lambda: ([x.cpu().numpy() for x in arrays], still_active.cpu().numpy()))
    assert not still_active.any(), "game exceeded turn limit?"
    return arrays


def eval_vs_opponent(agent: PolicySpec, opponent: PolicySpec, n_games: int = 400, seed: int = 0,
                     rng_mode: str = "fast", device="cuda") -> Dict:
    """`agent` as player 0 against `opponent` over n_games fresh deals."""
    with trace.span("eval"):
        res = summarize(*_match(agent, opponent, n_games, seed, rng_mode, device))
    res["privileged"] = {"agent": is_privileged(agent), "opponent": is_privileged(opponent)}
    return res


def head_to_head(a: PolicySpec, b: PolicySpec, n_games: int = 400, seed: int = 0,
                 rng_mode: str = "fast", device="cuda") -> Dict:
    """Seat-averaged head-to-head: `n_games` with `a` as player 0 and
    `n_games` with `b` as player 0, scored from `a`'s side over both orders.

    Scoring is from the raw final rewards: win +1, loss -1; a stalemate (0)
    and a turn-limit draw (-0.1 for both seats) are draws worth 0.5 points.
    The two seat orders play IDENTICAL initial deals (game i of each order
    starts from the same shuffle: both matches seed their generator alike
    and deal first), and the CI is computed over the per-deal paired means,
    so a policy against itself scores exactly 0.5 +- 0.

    Returns `score` (a's mean points in [0, 1] over 2 * n_games), the paired
    `score_ci95`, win/draw/loss counts and the per-seat splits.
    """
    per_seat = []
    pts = []
    for order, (p0, p1) in enumerate(((a, b), (b, a))):
        with trace.span("eval"):
            fr, *rest = _match(p0, p1, n_games, seed, rng_mode, device)
        win_p0 = fr > 0.5
        loss_p0 = fr < -0.5
        draw = ~win_p0 & ~loss_p0
        a_won = loss_p0 if order else win_p0
        pts.append(a_won.astype(np.float64) + 0.5 * draw)
        seat = summarize(fr, *rest)
        seat["a_wins"] = int(a_won.sum())
        seat["a_draws"] = int(draw.sum())
        seat["a_losses"] = int(n_games - a_won.sum() - draw.sum())
        per_seat.append(seat)
    pair_means = (pts[0] + pts[1]) / 2.0
    n = 2 * n_games
    wins = per_seat[0]["a_wins"] + per_seat[1]["a_wins"]
    draws = per_seat[0]["a_draws"] + per_seat[1]["a_draws"]
    return {
        "n": n,
        "n_pairs": n_games,
        "paired_deals": True,
        "score": float(pair_means.mean()),
        "score_ci95": float(1.96 * np.sqrt(max(pair_means.var(), 0.0) / n_games)),
        "wins": wins,
        "draws": draws,
        "losses": n - wins - draws,
        "win_rate": wins / n,
        "privileged": {"a": is_privileged(a), "b": is_privileged(b)},
        "first_seat": per_seat[0],
        "second_seat": per_seat[1],
    }


def run_evaluation_suite(params: ac.ActorCritic, n_games: int = 400, seed: int = 0,
                         opponents: Optional[list] = None, device="cuda") -> Dict[str, Dict]:
    """The model, greedy, against random / greedy_v1 / basic / itself."""
    agent = model_greedy_policy(params)
    opponents = opponents or ["random", "greedy_v1", "basic", "self"]
    results = {}
    for i, name in enumerate(opponents):
        opp = agent if name == "self" else heuristic_policy(name)
        results[name] = eval_vs_opponent(agent, opp, n_games, seed + i, device=device)
    return results


def bot_round_robin(pairs: list, n_games: int = 200, seed: int = 0,
                    device="cuda") -> Dict[str, Dict]:
    """Pairwise matches between named heuristics."""
    results = {}
    for i, (left, right) in enumerate(pairs):
        results[f"{left}:{right}"] = eval_vs_opponent(
            heuristic_policy(left), heuristic_policy(right), n_games, seed + i, device=device)
    return results

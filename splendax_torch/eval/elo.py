"""League evaluation: a round-robin of the pool's snapshots with a
Bradley-Terry / Elo fit.

Counterpart of `splendax/eval/elo.py`.  The training pool holds up to
`pool_size` frozen snapshots as stacked weights (`selfplay/pool.py`); every
filled snapshot and the CURRENT slot play every other one, and ratings are
fit by Bradley-Terry maximum likelihood (minorization-maximization updates),
reported on the Elo scale anchored at mean 1000.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.fused_actor_critic import PreparedWeights

ELO_SCALE = 400.0 / np.log(10.0)  # natural-log strength -> Elo points


def bradley_terry_elo(score: np.ndarray, games: np.ndarray, iters: int = 200) -> np.ndarray:
    """Fit Elo ratings from a round-robin score table.

    `score[i, j]` = points player i took off player j (wins + 0.5 * draws);
    `games[i, j]` = games between i and j (score[i, j] + score[j, i] ==
    games[i, j] == games[j, i]).  Returns ratings with mean 1000.  Uses the
    MM update for Bradley-Terry strengths p_i: p_i <- W_i / sum_j games_ij /
    (p_i + p_j), which increases the likelihood monotonically (Hunter 2004).
    """
    n = score.shape[0]
    assert score.shape == (n, n) and games.shape == (n, n)
    # Laplace smoothing keeps strengths finite for 100% and 0% players.
    wins = score.sum(axis=1) + 0.5
    p = np.ones(n, dtype=np.float64)
    for _ in range(iters):
        denom = np.zeros(n, dtype=np.float64)
        for i in range(n):
            opp = games[i] > 0
            denom[i] = (games[i, opp] / (p[i] + p[opp])).sum()
            denom[i] += 1.0 / (p[i] + 1.0)  # smoothing against a unit-strength ghost
        p = wins / denom
        p = p / np.exp(np.mean(np.log(p)))  # renormalize (gauge freedom)
    elo = ELO_SCALE * np.log(p)
    return elo - elo.mean() + 1000.0


def pool_round_robin(stack, n_entries: int, n_games: int = 100, seed: int = 0,
                     labels: Optional[list] = None, device="cuda") -> Dict:
    """Round-robin between entries `0..n_entries-1` of stacked kernel
    weights.  Each ordered pair plays `n_games` with i as player 0, so both
    seat orders run.  Returns {"elo": {label: rating}, "score": matrix,
    "games": matrix, "pairs": {...}}."""
    from .suite import _greedy_model_fn, eval_vs_opponent

    device = resolve_device(device)
    labels = labels or [f"snap{i}" for i in range(n_entries)]
    assert len(labels) == n_entries
    policies = [(_greedy_model_fn,
                 PreparedWeights([w[i].to(device).contiguous() for w in stack]))
                for i in range(n_entries)]

    score = np.zeros((n_entries, n_entries))
    games = np.zeros((n_entries, n_entries))
    pairs = {}
    for i in range(n_entries):
        for j in range(n_entries):
            if i == j:
                continue
            res = eval_vs_opponent(policies[i], policies[j], n_games, seed + 1000 * i + j,
                                   device=device)
            score[i, j] += res["wins"] + 0.5 * res["draws"]
            score[j, i] += res["losses"] + 0.5 * res["draws"]
            games[i, j] += res["n"]
            games[j, i] += res["n"]
            pairs[f"{labels[i]}:{labels[j]}"] = res
    elo = bradley_terry_elo(score, games)
    order = np.argsort(-elo)
    return {
        "elo": {labels[i]: float(elo[i]) for i in order},
        "score": score.tolist(),
        "games": games.tolist(),
        "pairs": pairs,
    }


def load_pool_stack(checkpoint_path: str):
    """(stack, n_entries, labels) from a training checkpoint
    (`train/checkpoint.py`'s `<log_dir>/ppo_splendor_latest.pt`): the filled
    snapshots, then the CURRENT slot (the params that played the last rollout
    before it was saved) as the last entry, labeled 'current'.  The stack stays on the CPU."""
    saved = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    pool = saved["pool"]
    pool_size = pool["stack"][0].shape[0] - 1
    filled = int(min(int(pool["n_snapshots"]), pool_size))
    keep = list(range(filled)) + [pool_size]  # snapshots + CURRENT
    sub = [w[keep] for w in pool["stack"]]
    labels = [f"snap{i}" for i in range(filled)] + ["current"]
    return sub, filled + 1, labels

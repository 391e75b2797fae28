"""Scripted verification games saved under game_logs/ for manual rule
checks.  Counterpart of `splendax/tools/simple_game_test.py`; runs on the
card unless `main(argv, device="cpu")` is called."""

from __future__ import annotations

import argparse
import os

from .game_logger import run_logged_game

SCENARIOS = [
    ("random_game", "random", 42),
    ("first_legal_game", "first", 7),
    ("random_game_2", "random", 1234),
]


def main(argv=None, device="cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out-dir", default="game_logs")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, policy, seed in SCENARIOS:
        path = os.path.join(args.out_dir, f"{name}.log")
        env, logger = run_logged_game(policy, seed, save_path=path, device=device)
        winner = int(env.state.winner[0])
        result = "draw" if winner < 0 else f"P{winner} wins"
        print(f"{name}: {len(logger.logs)} plies, turns={int(env.state.turn_count[0])},"
              f" {result} -> {path}")


if __name__ == "__main__":
    main()

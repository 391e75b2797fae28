"""Random-rollout smoke CLI.

Counterpart of `splendax/tools/random_rollout.py`: N episodes of uniform
random legal play with per-episode stats, through the gym-compatible
`SplendorEnv`; `--device` plays them as one batched match of the port's
engine instead.  Runs on the card unless `main(argv, device="cpu")` is
called.

    python -m splendax_torch.tools.random_rollout --episodes 2 --device
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def host_rollouts(episodes: int, seed: int, max_steps: int = 500, device="cuda") -> None:
    from ..env.gym_compat import SplendorEnv

    rng = np.random.RandomState(seed)
    env = SplendorEnv(device=device)
    for ep in range(episodes):
        obs, info = env.reset(seed=int(rng.randint(1_000_000_000)))
        total_r, steps = 0.0, 0
        for _ in range(max_steps):
            legal = np.flatnonzero(info["action_mask"])
            a = 0 if legal.size == 0 else int(rng.choice(legal))
            obs, r, term, trunc, info = env.step(a)
            total_r += r
            steps += 1
            if term or trunc:
                break
        print(f"episode {ep}: steps={steps} reward={total_r:+.2f}"
              f" turns={int(env.state.turn_count[0])}")


def device_rollouts(episodes: int, seed: int, device="cuda") -> None:
    from ..eval.suite import eval_vs_opponent, heuristic_policy

    t0 = time.time()
    res = eval_vs_opponent(heuristic_policy("random"), heuristic_policy("random"), episodes,
                           seed, device=device)
    dt = time.time() - t0
    print(f"{episodes} games on {device} in {dt:.2f}s: "
          f"p0 wr={res['win_rate']:.3f} avg_turns={res['avg_turns']:.1f} "
          f"draws={res['draws']}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="random legal-play rollouts")
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", action="store_true", help="batched on-device run")
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> None:
    args = parse_args(argv)
    if args.device:
        device_rollouts(args.episodes, args.seed, device)
    else:
        host_rollouts(args.episodes, args.seed, device=device)


if __name__ == "__main__":
    main()

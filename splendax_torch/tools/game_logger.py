"""Human-readable game rendering, action decoding and logged games.

Counterpart of `splendax/tools/game_logger.py`, with the same text: compact
cards and tokens, decoded actions, state snapshots, per-round logs,
`run_logged_game` and the CLI.  States are the port's `GameState` with B=1
(game 0 of a batch is shown).

    python -m splendax_torch.tools.game_logger --policy random --seed 3 --quiet

The game runs on the card unless `main(argv, device="cpu")` is called; the
`model` policy runs the fused actor-critic kernel at B=1, the `search`
policy the port's PUCT search (`search/uct.py`).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..engine import data as D
from ..engine import rules as R
from ..engine.state import GameState

# w=white, b=blue, g=green, r=red, k=black, G=gold
COLOR_ABBREV = ["w", "b", "g", "r", "k", "G"]


def _game(state: GameState) -> dict:
    """Game 0 of `state` as numpy arrays on the host."""
    return {k: v[0].detach().cpu().numpy() for k, v in state.items()}


def _fmt_card(card_id: int) -> str:
    """`g-1pt-2b3r3k`: colour, points and cost of a card."""
    if card_id < 0:
        return "[empty]"
    color = COLOR_ABBREV[int(D.CARD_COLOR[card_id])]
    pts = int(D.CARD_POINTS[card_id])
    cost_parts = [
        f"{int(c)}{COLOR_ABBREV[i]}" for i, c in enumerate(D.CARD_COST[card_id]) if c > 0
    ]
    cost = "".join(cost_parts) if cost_parts else "free"
    return f"{color}-{pts}pt-{cost}"


def _fmt_vec(vec, n=6) -> str:
    parts = [f"{int(v)}{COLOR_ABBREV[i]}" for i, v in enumerate(vec[:n]) if v > 0]
    return "".join(parts) if parts else "none"


def decode_action(action: int, state: GameState) -> str:
    """Action number -> compact text."""
    g = _game(state)
    bank = g["bank"]
    if R.TAKE3_OFFSET <= action < R.TAKE3_OFFSET + R.TAKE3_COUNT:
        avail = [i for i in range(5) if bank[i] >= 1]
        if len(avail) >= 3:
            combo = D.TAKE3_COMBOS[action - R.TAKE3_OFFSET]
            return "Take3: " + "".join(COLOR_ABBREV[c] for c in combo)
        if len(avail) == 2:
            return "Take2: " + "".join(COLOR_ABBREV[c] for c in avail) + " (reduced)"
        if len(avail) == 1:
            return f"Take1: {COLOR_ABBREV[avail[0]]} (reduced)"
        return "Take0 (no tokens available)"
    if R.TAKE2_OFFSET <= action < R.TAKE2_OFFSET + R.TAKE2_COUNT:
        c = COLOR_ABBREV[action - R.TAKE2_OFFSET]
        return f"Take2: {c}{c}"
    if R.BUY_VISIBLE_OFFSET <= action < R.BUY_VISIBLE_OFFSET + R.BUY_VISIBLE_COUNT:
        off = action - R.BUY_VISIBLE_OFFSET
        tier, slot = off // 4, off % 4
        return f"Buy: T{tier+1}S{slot+1} {_fmt_card(int(g['board'][tier, slot]))}"
    if R.RESERVE_VISIBLE_OFFSET <= action < R.RESERVE_VISIBLE_OFFSET + R.RESERVE_VISIBLE_COUNT:
        off = action - R.RESERVE_VISIBLE_OFFSET
        tier, slot = off // 4, off % 4
        return f"Reserve: T{tier+1}S{slot+1} {_fmt_card(int(g['board'][tier, slot]))}"
    if R.RESERVE_BLIND_OFFSET <= action < R.RESERVE_BLIND_OFFSET + R.RESERVE_BLIND_COUNT:
        return f"Reserve: T{action - R.RESERVE_BLIND_OFFSET + 1} blind"
    if R.BUY_RESERVED_OFFSET <= action < R.BUY_RESERVED_OFFSET + R.BUY_RESERVED_COUNT:
        slot = action - R.BUY_RESERVED_OFFSET
        cid = int(g["reserved_ids"][int(g["to_play"]), slot])
        return f"BuyReserved: #{slot+1} {_fmt_card(cid)}"
    return f"Action{action}"


def format_game_state(state: GameState, player_perspective: int = -1) -> str:
    """Compact snapshot of game 0 of `state`."""
    g = _game(state)
    lines = [
        f"=== Turn {int(g['turn_count'])} | Move {int(g['move_count'])}"
        f" | P{int(g['to_play'])} to play ===",
        f"Bank: {_fmt_vec(g['bank'])}",
    ]
    for t in range(3):
        cards = "  ".join(f"S{s+1}:{_fmt_card(int(g['board'][t, s]))}" for s in range(4))
        lines.append(f"T{t+1} ({int(g['deck_count'][t])} in deck): {cards}")
    nobles = [f"N{int(n)}:{_fmt_vec(D.NOBLE_REQ[int(n)], 5)}" for n in g["noble_ids"] if n >= 0]
    lines.append("Nobles: " + (", ".join(nobles) if nobles else "none"))
    for p in range(2):
        tok = _fmt_vec(g["tokens"][p])
        bon = _fmt_vec(g["bonuses"][p], 5)
        res = []
        for i in range(int(g["reserved_count"][p])):
            vis = "public" if int(g["reserved_revealed"][p, i]) else "hidden"
            res.append(f"{_fmt_card(int(g['reserved_ids'][p, i]))}({vis})")
        lines.append(
            f"P{p}: {int(g['prestige'][p])}pts tokens[{tok}] bonuses[{bon}]"
            f" reserved[{', '.join(res) if res else 'none'}]"
        )
    if bool(g["game_over"]):
        w = int(g["winner"])
        lines.append(f"GAME OVER: {'draw' if w < 0 else f'P{w} wins'}"
                     + (" (turn limit)" if bool(g["turn_limit_reached"]) else ""))
    return "\n".join(lines)


@dataclass
class GameLog:
    """One logged ply."""

    step: int
    turn: int
    player: int
    action: str
    state_after: str
    reward: float = 0.0


@dataclass
class SplendorGameLogger:
    """Collects per-ply logs and prints them grouped into full rounds."""

    logs: List[GameLog] = field(default_factory=list)

    def log_game_step(self, step: int, state_before: GameState, action: int,
                      state_after: GameState, reward: float = 0.0) -> None:
        self.logs.append(
            GameLog(
                step=step,
                turn=int(state_before.turn_count[0]),
                player=int(state_before.to_play[0]),
                action=decode_action(int(action), state_before),
                state_after=format_game_state(state_after),
                reward=float(reward),
            )
        )

    def print_game_log(self, verbose: bool = True) -> str:
        out = []
        cur_turn = None
        for log in self.logs:
            if log.turn != cur_turn:
                cur_turn = log.turn
                out.append(f"\n──── Round {log.turn} ────")
            out.append(f"[{log.step:3d}] P{log.player}: {log.action}"
                       + (f"  (r={log.reward:+.2f})" if log.reward else ""))
            if verbose:
                out.append(log.state_after)
        text = "\n".join(out)
        print(text)
        return text

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            cur_turn = None
            for log in self.logs:
                if log.turn != cur_turn:
                    cur_turn = log.turn
                    f.write(f"\n──── Round {log.turn} ────\n")
                f.write(f"[{log.step:3d}] P{log.player}: {log.action}\n")
                f.write(log.state_after + "\n")


def _model_policy(npz_path: str, device="cuda"):
    """Greedy masked-argmax policy of an exported params .npz, through the
    fused forward at B=1."""
    from ..models.actor_critic import import_params_npz
    from ..selfplay.wrappers import frozen_policy_from

    policy = frozen_policy_from(import_params_npz(npz_path, device=device))
    return lambda obs, mask: policy(obs, {"action_mask": mask})


def _search_policy(npz_path: Optional[str], sims: int = 64, device="cuda"):
    """PUCT tree search (search/uct.py) for single-game host play; the net
    of `npz_path` gives priors and leaf values, else heuristic ones."""
    import torch

    from ..search import uct_search_policy

    params = None
    if npz_path:
        from ..models.actor_critic import import_params_npz

        params = import_params_npz(npz_path, device=device)
    fn, ctx = uct_search_policy(sims, params=params)

    def act(obs, mask, state):
        a = fn(ctx, torch.as_tensor(obs, device=device)[None],
               torch.as_tensor(np.asarray(mask) > 0, device=device)[None],
               state.map(lambda x: x.to(device)))
        return int(a[0])

    return act


def run_logged_game(
    policy_type: str = "random",
    seed: int = 0,
    max_steps: int = 1000,
    save_path: Optional[str] = None,
    verbose: bool = False,
    npz: Optional[str] = None,
    opponent: Optional[str] = None,
    sims: int = 64,
    device="cuda",
):
    """Play one game, logging every ply.  Policies: random / first /
    interactive (an action index from stdin) / model (the greedy net of
    `npz`) / search (PUCT, over the net of `npz` when given).  With
    `opponent`, that policy drives player 1 and `policy_type` player 0."""
    from ..env.gym_compat import SplendorEnv

    rng = np.random.RandomState(seed)
    env = SplendorEnv(num_players=2, device=device)
    logger = SplendorGameLogger()
    obs, info = env.reset(seed=seed)
    model_act = _model_policy(npz, device) if npz else None
    search_act = None
    if "search" in (policy_type, opponent):
        search_act = _search_policy(npz, sims, device)

    def choose(kind: str, obs, mask) -> int:
        legal = np.flatnonzero(mask)
        if legal.size == 0:
            return 0
        if kind == "random":
            return int(rng.choice(legal))
        if kind == "first":
            return int(legal[0])
        if kind == "model":
            if model_act is None:
                raise ValueError("policy 'model' needs --npz <params.npz>")
            return model_act(obs, mask)
        if kind == "search":
            return search_act(obs, mask, env.state)
        if kind == "interactive":
            print(format_game_state(env.state))
            print("legal:", [f"{x}:{decode_action(int(x), env.state)}" for x in legal])
            return int(input("action> "))
        raise ValueError(f"unknown policy {kind}")

    for step_i in range(max_steps):
        mask = info["action_mask"]
        mover = policy_type if (opponent is None or int(info["to_play"]) == 0) else opponent
        a = choose(mover, obs, mask)
        before = env.state
        obs, r, term, trunc, info = env.step(a)
        logger.log_game_step(step_i, before, a, env.state, r)
        if term or trunc:
            break
    if verbose:
        logger.print_game_log(verbose=False)
    if save_path:
        logger.save(save_path)
    return env, logger


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Play and log a verification game")
    ap.add_argument("--policy", default="random",
                    choices=["random", "first", "interactive", "model", "search"])
    ap.add_argument("--opponent", default=None,
                    choices=["random", "first", "model", "search"],
                    help="drive player 1 with a different policy "
                         "(e.g. --policy interactive --opponent search)")
    ap.add_argument("--npz", default=None,
                    help="params .npz for the 'model'/'search' policies "
                         "(e.g. runs/ppo_splendor_2b_h512/ppo_splendor_params.npz)")
    ap.add_argument("--sims", type=int, default=64,
                    help="tree simulations per move for the 'search' policy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None, help="write the log to this path")
    ap.add_argument("--quiet", action="store_true")
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> None:
    args = parse_args(argv)
    env, logger = run_logged_game(
        args.policy, args.seed, save_path=args.save, verbose=not args.quiet,
        npz=args.npz, opponent=args.opponent, sims=args.sims, device=device,
    )
    print(format_game_state(env.state))


if __name__ == "__main__":
    main()

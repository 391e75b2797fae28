"""The port's tools against the JAX package's: the game logger's text
(decoded actions, state snapshots, logged games, the CLI), the rollout CLIs,
the scripted games, the take-3 demo and the card CSV pipeline.  Text is
compared exactly; the JAX CLIs run in-process with their runtime setup (a
compile-cache switch) left out.

The JAX logger runs on its JAX backend here: on its native backend
`NativeGame.to_game_state` may alias the flat state that the next step
overwrites, so the logged "before" state can be the state after the move
(`splendax/native/__init__.py:189-205`); the port's copy does not alias."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from splendax.engine.types import GameState as JGameState
from splendax.tools import game_logger as jlogger
from splendax.tools import random_rollout as jrollout
from splendax.tools import simple_game_test as jsimple
from splendax.tools import take3_demo as jtake3
from splendax.tools.build_cards_from_csv import parse_cards_csv as jparse
from splendax_torch.engine import rules, state as S
from splendax_torch.env import core
from splendax_torch.models import actor_critic as ac
from splendax_torch.tools import (build_cards_from_csv, export_cards_to_csv, game_logger,
                                  random_rollout, simple_game_test, take3_demo)
from test_torch_rollout import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_CSV = os.path.join(REPO, "data", "splendor_cards.csv")


@pytest.fixture
def jax_backend(monkeypatch):
    """The JAX package's "auto" env picks its JAX backend."""
    import splendax.native

    monkeypatch.setattr(splendax.native, "is_available", lambda: False)


@pytest.fixture
def jax_cli(monkeypatch, jax_backend):
    """Runs a JAX tool's `main` with `argv` and without its runtime setup,
    which would repoint this process's JAX compile cache."""
    import sys

    import splendax.utils.cache

    monkeypatch.setattr(splendax.utils.cache, "setup_runtime", lambda *a, **k: None)

    def run(main, argv=()):
        monkeypatch.setattr(sys, "argv", ["prog", *argv])
        main()

    return run


def game_states(seed, plies=400):
    """The states of one random parity game on the port's engine, B=1."""
    rng = np.random.RandomState(seed)
    st = S.initial_state_parity(seed, "cpu")
    out = [st]
    for _ in range(plies):
        legal = np.flatnonzero(rules.legal_mask(st)[0].numpy())
        if bool(rules.is_terminal(st)[0]):
            break
        st, _ = core.step(st, torch.tensor([int(rng.choice(legal)) if len(legal) else 0]),
                          rng_mode="parity")
        out.append(st)
    return out


def to_jax_game(st):
    return JGameState(**{k: jnp.asarray(v[0]) for k, v in S.to_numpy(st).items()})


def test_decode_and_format_match_jax_over_a_game():
    """Every state of two games: the snapshot text, and the text of all 45
    actions, equal the JAX package's; reserved cards, a reduced take and
    the game-over line all appear."""
    seen = set()
    for seed in (3, 11):
        for st in game_states(seed):
            js = to_jax_game(st)
            text = game_logger.format_game_state(st)
            assert text == jlogger.format_game_state(js)
            for a in range(45):
                d = game_logger.decode_action(a, st)
                assert d == jlogger.decode_action(a, js), (seed, a)
                seen.add(d.split(":")[0])
            seen.update(w for w in ("GAME OVER", "public", "hidden") if w in text)
    assert {"Take3", "Take2", "Buy", "Reserve", "BuyReserved", "GAME OVER", "public",
            "hidden"} <= seen


def same_logs(got, want):
    assert [vars(g) for g in got.logs] == [vars(w) for w in want.logs]


@pytest.mark.parametrize("policy,seed", [("random", 3), ("first", 5)])
def test_run_logged_game_matches_jax(tmp_path, jax_backend, policy, seed):
    """The same game, logs and saved file as the JAX logger's."""
    env, log = game_logger.run_logged_game(policy, seed, save_path=str(tmp_path / "p.log"),
                                           device="cpu")
    _, jlog = jlogger.run_logged_game(policy, seed, save_path=str(tmp_path / "j.log"))
    same_logs(log, jlog)
    assert len(log.logs) > 10
    assert (tmp_path / "p.log").read_bytes() == (tmp_path / "j.log").read_bytes()
    assert bool(env.state.game_over[0])


def test_run_logged_game_model_vs_random_matches_jax(tmp_path, jax_backend):
    """`--policy model` (the greedy net of an npz, through the fused
    forward) against random, beside the JAX logger on the same npz."""
    path = str(tmp_path / "p.npz")
    ac.export_params_npz(ac.params_from_jax(numpy_params(np.random.RandomState(0), 32),
                                            device="cpu"), path)
    _, log = game_logger.run_logged_game("model", 2, npz=path, opponent="random", device="cpu")
    _, jlog = jlogger.run_logged_game("model", 2, npz=path, opponent="random")
    same_logs(log, jlog)
    assert len(log.logs) > 4
    with pytest.raises(ValueError, match="npz"):
        game_logger.run_logged_game("model", seed=2, device="cpu")


def test_run_logged_game_search_opponent():
    """`--opponent search` drives player 1 with the port's PUCT search
    (heuristic priors and leaves without an npz); a few plies, all legal."""
    env, log = game_logger.run_logged_game("random", 4, opponent="search", sims=4,
                                           max_steps=6, device="cpu")
    assert len(log.logs) == 6 and {g.player for g in log.logs} == {0, 1}
    assert not any(g.reward < 0 for g in log.logs)  # no illegal action


def test_game_logger_cli_matches_jax(jax_cli, capsys):
    game_logger.main(["--seed", "3"], device="cpu")
    got = capsys.readouterr().out
    jax_cli(jlogger.main, ["--seed", "3"])
    assert got == capsys.readouterr().out and "──── Round 1 ────" in got
    game_logger.main(["--seed", "3", "--quiet"], device="cpu")
    assert "GAME OVER" in capsys.readouterr().out


def test_random_rollout_cli(jax_cli, capsys):
    """Host episodes print what the JAX tool prints; the batched run
    prints its summary line (its deals come from the port's generator)."""
    random_rollout.main(["--episodes", "2"], device="cpu")
    got = capsys.readouterr().out
    jax_cli(jrollout.main, ["--episodes", "2"])
    assert got == capsys.readouterr().out and "episode 1:" in got
    random_rollout.main(["--episodes", "8", "--device"], device="cpu")
    assert re.fullmatch(r"8 games on cpu in [0-9.]+s: p0 wr=[0-9.]+ avg_turns=[0-9.]+ "
                        r"draws=\d+\n", capsys.readouterr().out)


def test_simple_game_test_matches_jax(tmp_path, jax_cli, capsys):
    simple_game_test.main(["--out-dir", str(tmp_path / "p")], device="cpu")
    got = capsys.readouterr().out
    jax_cli(jsimple.main, ["--out-dir", str(tmp_path / "j")])
    want = capsys.readouterr().out
    assert got.replace(str(tmp_path / "p"), "") == want.replace(str(tmp_path / "j"), "")
    for name, _, _ in simple_game_test.SCENARIOS:
        assert f"{name}:" in got
        p, j = tmp_path / "p" / f"{name}.log", tmp_path / "j" / f"{name}.log"
        assert p.stat().st_size > 1000 and p.read_bytes() == j.read_bytes()


def test_take3_demo_matches_jax(jax_cli, capsys):
    take3_demo.main(device="cpu")
    got = capsys.readouterr().out
    jax_cli(jtake3.main)
    assert got == capsys.readouterr().out
    for n in (10, 3, 6, 0):
        assert f"{n} legal combos" in got


def test_card_csv_round_trip(tmp_path, capsys):
    """The exporter writes the committed CSV byte for byte; the builder
    turns it back into the port's cards.json byte for byte, which equals the
    JAX package's; both parsers read the same tables."""
    csv_out, json_out = str(tmp_path / "cards.csv"), str(tmp_path / "cards.json")
    export_cards_to_csv.main(["-o", csv_out])
    assert "Wrote 90 cards" in capsys.readouterr().out
    build_cards_from_csv.main([csv_out, "-o", json_out])
    assert "Wrote 90 cards" in capsys.readouterr().out
    with open(csv_out, "rb") as f, open(COMMITTED_CSV, "rb") as g:
        assert f.read() == g.read()
    for shipped in ("splendax_torch/engine/data/cards.json", "splendax/engine/data/cards.json"):
        with open(json_out, "rb") as f, open(os.path.join(REPO, shipped), "rb") as g:
            assert f.read() == g.read(), shipped
    assert build_cards_from_csv.parse_cards_csv(COMMITTED_CSV) == jparse(COMMITTED_CSV)


def test_tools_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for run in (lambda: random_rollout.main(["--episodes", "1"]),
                lambda: random_rollout.main(["--episodes", "1", "--device"]),
                lambda: game_logger.main(["--quiet"]), lambda: take3_demo.main(),
                lambda: simple_game_test.main(["--out-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()

"""The port's eval CLI (`python -m splendax_torch.eval.cli`) and Elo ladder
(`eval/elo.py`) against the JAX package's: the same flags and defaults, the
same result names, keys and printed lines, every subcommand through
`main(argv, device="cpu")` at a few games, and the Bradley-Terry fit within
1e-9."""

import argparse
import json
import re

import numpy as np
import pytest
import torch

from splendax.eval import cli as jcli
from splendax.eval import elo as jelo
from splendax.models import actor_critic as jac
from splendax_torch.eval import cli, elo
from splendax_torch.models import actor_critic as ac
from splendax_torch.train import train
from test_torch_rollout import numpy_params

RESULT_KEYS = {"n", "wins", "losses", "draws", "win_rate", "win_rate_ci95", "avg_turns",
               "avg_prestige", "illegal_action_rate", "privileged"}
LINE = re.compile(r"^\S+: wr=\d\.\d{3}±\d\.\d{3} W/D/L=\d+/\d+/\d+ avg_turns=\d+\.\d\d "
                  r"avg_prestige=\d+\.\d\d illegal=0\.0000( \[privileged: [a-z,]+\])?$")


class _Parsed(Exception):
    pass


def jax_cli_parser(monkeypatch):
    """The JAX CLI builds its parser inside `main`: catch it at parse time."""
    seen = {}

    def grab(self, argv=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        jcli.main(["bots"])
    monkeypatch.undo()
    return seen["parser"]


def test_cli_flags_and_defaults_equal_the_jax_cli(monkeypatch):
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type,
                         None if a.choices is None else tuple(a.choices), type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    want, got = table(jax_cli_parser(monkeypatch)), table(cli.build_parser())
    assert got == want
    assert len(want["command"][4]) == 9 and got["command"][4] == tuple(cli.COMMANDS)
    args = cli.build_parser().parse_args(["vs-search"])
    assert (args.algo, args.sims, args.gumbel_m, args.gumbel_k0, args.rollouts, args.horizon,
            args.games, args.seed, args.greedy_final) == ("mc", 64, 16, 6, 8, 24, 400, 0, False)


def run(argv, tmp_path, capsys):
    out = tmp_path / "out.json"
    cli.main(argv + ["--json-out", str(out)], device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1] == f"wrote {out}"
    with open(out) as f:
        return json.load(f), printed[:-1]


def test_bots(tmp_path, capsys):
    res, printed = run(["bots", "--pairs", "basic:greedy_v1", "random:noble", "greedy_v2:basic",
                        "--games", "8", "--seed", "3"], tmp_path, capsys)
    assert list(res) == ["basic:greedy_v1", "random:noble", "greedy_v2:basic"]
    for name, line in zip(res, printed):
        r = res[name]
        assert set(r) == RESULT_KEYS and r["n"] == 8 and r["wins"] + r["losses"] + r["draws"] == 8
        assert line.startswith(name + ": ") and LINE.match(line), line
    assert res["greedy_v2:basic"]["privileged"] == {"agent": True, "opponent": False}
    assert printed[2].endswith(" [privileged: agent]")


def test_bots_prints_and_writes_as_the_jax_cli_does(tmp_path, capsys):
    """The same command through both CLIs: the same result names, keys,
    value types and line format (the deals differ: another generator)."""
    argv = ["bots", "--pairs", "greedy_v1:greedy_v2", "--games", "4"]
    got, got_lines = run(argv, tmp_path, capsys)
    jout = tmp_path / "jax.json"
    jcli.main(argv + ["--json-out", str(jout)])
    want_lines = capsys.readouterr().out.strip().splitlines()[:-1]
    with open(jout) as f:
        want = json.load(f)
    assert list(got) == list(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        assert {k: type(v) for k, v in got[name].items()} == {k: type(v) for k, v in want[name].items()}
        assert got[name]["privileged"] == want[name]["privileged"]
    assert len(got_lines) == len(want_lines) == 1
    assert LINE.match(got_lines[0]) and LINE.match(want_lines[0])
    assert got_lines[0].split(" ")[0] == want_lines[0].split(" ")[0]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("net") / "params.npz")
    ac.export_params_npz(ac.params_from_jax(numpy_params(np.random.RandomState(0), 32), "cpu"), path)
    return path


@pytest.mark.parametrize("command,name,extra", [
    ("vs-random", "model_vs_random", ["--stochastic"]),
    ("vs-basic", "model_vs_basic", []),
    ("basic-vs-model", "basic_vs_model", []),
    ("vs-noble", "model_vs_noble", []),
    ("vs-model", "model_vs_model", ["opp"]),
])
def test_model_commands(command, name, extra, npz, tmp_path, capsys):
    extra = ["--opp-npz", npz] if extra == ["opp"] else extra
    res, printed = run([command, "--npz", npz, "--games", "6"] + extra, tmp_path, capsys)
    assert list(res) == [name] and set(res[name]) == RESULT_KEYS and res[name]["n"] == 6
    assert res[name]["illegal_action_rate"] == 0.0
    assert LINE.match(printed[-1]) and printed[-1].startswith(name + ": ")


def test_without_a_checkpoint_random_params_are_used(tmp_path, capsys):
    res, printed = run(["vs-random", "--games", "4"], tmp_path, capsys)
    assert printed[0] == "[eval] no checkpoint given; using random-init params"
    assert res["model_vs_random"]["n"] == 4


def test_both_seats_gives_the_head_to_head_result(npz, tmp_path, capsys):
    res, printed = run(["vs-basic", "--npz", npz, "--games", "4", "--both-seats"], tmp_path, capsys)
    r = res["model_vs_basic"]
    assert r["n"] == 8 and r["n_pairs"] == 4 and r["paired_deals"] and 0.0 <= r["score"] <= 1.0
    assert set(r["privileged"]) == {"a", "b"}
    assert re.match(r"^model_vs_basic: score=\d\.\d{3}±\d\.\d{3} W/D/L=\d+/\d+/\d+ "
                    r"seat wins \d+/\d+ of 4$", printed[-1]), printed[-1]


@pytest.mark.parametrize("algo,flags,tag,privileged", [
    ("mc", ["--rollouts", "2", "--horizon", "2"], "mc(r2,h2)", True),
    ("cmc", ["--rollouts", "2", "--horizon", "2"], "cmc(r2,h2)", False),
    ("uct", ["--sims", "4"], "uct(s4)", True),
    ("gumbel", ["--gumbel-m", "4", "--gumbel-k0", "1", "--horizon", "2", "--greedy-final"],
     "gumbel(m4,k1,h2)", True),
    ("cgumbel", ["--gumbel-m", "4", "--gumbel-k0", "1", "--horizon", "2"], "cgumbel(m4,k1,h2)",
     False),
])
@pytest.mark.parametrize("with_net", [False, True])
def test_vs_search(algo, flags, tag, privileged, with_net, npz, tmp_path, capsys):
    """Every search bot, without a net against the basic heuristic and with
    one (`--search-npz`) against the model."""
    who = ["--npz", npz, "--search-npz", npz] if with_net else ["--agent", "basic"]
    res, printed = run(["vs-search", "--algo", algo, "--games", "4"] + flags + who, tmp_path, capsys)
    name = f"{'model' if with_net else 'basic'}_vs_{tag}"
    assert list(res) == [name], list(res)
    r = res[name]
    assert set(r) == RESULT_KEYS and r["n"] == 4 and r["illegal_action_rate"] == 0.0
    assert r["privileged"] == {"agent": False, "opponent": privileged}
    assert LINE.match(printed[-1]), printed[-1]
    assert printed[-1].endswith(" [privileged: opponent]") == privileged


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny `train()` run with two snapshots in its pool."""
    log_dir = str(tmp_path_factory.mktemp("run"))
    cfg = train.parse_args(["--num-envs", "8", "--num-steps", "8", "--hidden", "16",
                            "--total-timesteps", str(4 * 64), "--minibatch-size", "32",
                            "--update-epochs", "1", "--eval-games", "4", "--eval-every-updates", "99",
                            "--snapshot-every-updates", "2", "--pool-size", "3", "--log-dir", log_dir])
    ts = train.train(cfg, device="cpu")
    return log_dir, ts


def test_suite_on_a_trained_run(trained, tmp_path, capsys):
    log_dir, _ = trained
    res, printed = run(["suite", "--npz", f"{log_dir}/ppo_splendor_params.npz", "--games", "4"],
                       tmp_path, capsys)
    assert list(res) == ["random", "greedy_v1", "basic", "self"]
    assert all(set(r) == RESULT_KEYS and r["n"] == 4 for r in res.values())
    assert [line.split(":")[0] for line in printed[-4:]] == list(res)


def test_pool_elo_on_a_training_checkpoint(trained, tmp_path, capsys):
    """`pool-elo` reads the port's `.pt` checkpoint: two snapshots and
    CURRENT, six ordered pairs, ratings with mean 1000, printed best first."""
    log_dir, ts = trained
    ckpt = f"{log_dir}/ppo_splendor_latest.pt"
    stack, n, labels = elo.load_pool_stack(ckpt)
    assert (n, labels) == (3, ["snap0", "snap1", "current"]) and len(stack) == 12
    for got, want in zip(stack, ts.pool.stack):
        assert torch.equal(got, want[[0, 1, 3]])
    league, printed = run(["pool-elo", "--checkpoint", ckpt, "--games", "4", "--seed", "5"],
                          tmp_path, capsys)
    assert set(league) == {"elo", "score", "games", "pairs"}
    assert sorted(league["elo"]) == ["current", "snap0", "snap1"]
    assert abs(np.mean(list(league["elo"].values())) - 1000.0) < 1e-9
    assert list(league["elo"].values()) == sorted(league["elo"].values(), reverse=True)
    assert len(league["pairs"]) == 6 and all(set(r) == RESULT_KEYS for r in league["pairs"].values())
    score, games = np.asarray(league["score"]), np.asarray(league["games"])
    assert (games == 8 * (1 - np.eye(3))).all()
    np.testing.assert_array_equal(score + score.T, games)
    assert printed[0] == "pool league (3 entries, 4 games/ordered pair):"
    assert [re.match(r"^ +(\w+)  Elo +[\d.]+$", p).group(1) for p in printed[1:4]] == list(league["elo"])
    want = jelo.bradley_terry_elo(score, games)
    np.testing.assert_allclose([league["elo"][k] for k in labels], want, atol=1e-9, rtol=0)


def test_pool_elo_requires_a_checkpoint(capsys):
    with pytest.raises(SystemExit):
        cli.main(["pool-elo"], device="cpu")
    assert "pool-elo requires --checkpoint" in capsys.readouterr().err


@pytest.mark.parametrize("n", [2, 5, 13])
def test_bradley_terry_elo_equals_the_jax_packages_copy(n):
    """Within 1e-9 on a random round-robin table, with a player who won
    everything and one who lost everything."""
    rng = np.random.RandomState(n)
    games = np.triu(rng.randint(0, 40, (n, n)), 1).astype(np.float64)
    games = games + games.T
    frac = np.triu(rng.rand(n, n), 1)
    frac[0, 1:] = 1.0
    frac[:-1, -1] = 1.0
    upper = np.round(frac * np.triu(games, 1) * 2) / 2
    score = upper + (np.triu(games, 1) - upper).T
    want = jelo.bradley_terry_elo(score, games)
    got = elo.bradley_terry_elo(score, games)
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    assert abs(got.mean() - 1000.0) < 1e-9 and got[0] == got.max()
    assert elo.ELO_SCALE == jelo.ELO_SCALE


def test_torch_pt_loads_a_reference_state_dict(tmp_path, capsys):
    """`--torch-pt`: an `ActorCritic.state_dict()` with weights [out, in]
    gives the network the JAX package's `from_torch_state_dict` builds from
    it: logits and values within 1e-5."""
    import jax.numpy as jnp

    flat = numpy_params(np.random.RandomState(6), 24)
    sd = {}
    for head in ("actor", "critic"):
        for i in range(3):
            sd[f"{head}.{2 * i}.weight"] = torch.from_numpy(flat[f"{head}.{i}.w"].T.copy())
            sd[f"{head}.{2 * i}.bias"] = torch.from_numpy(flat[f"{head}.{i}.b"].copy())
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    model = cli._load_params(argparse.Namespace(npz=None, torch_pt=path), torch.device("cpu"))
    obs = np.random.RandomState(7).randint(0, 8, (32, 297)).astype(np.int32)
    logits, value = model(torch.from_numpy(obs))
    jlogits, jvalue = jac.forward(jac.from_torch_state_dict({k: v.numpy() for k, v in sd.items()}),
                                  jnp.asarray(obs))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue), rtol=1e-5, atol=1e-5)
    res, _ = run(["vs-model", "--torch-pt", path, "--opp-torch-pt", path, "--games", "4"],
                 tmp_path, capsys)
    assert res["model_vs_model"]["n"] == 4


def test_cli_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["bots", "--games", "2"])

"""The port's replay of the committed search duels and league evals
(`splendax_torch/eval/duel_replay.py`) against the JAX package's round
scripts (`scripts/round4_*.sh`, `scripts/round5_*.sh`) and the files they
wrote (`runs/search_duels/`), and the duel comparator
(`scripts/torch_ladder_compare.py --duel`) on files with and without
`n_pairs`, on the CPU."""

import json
import os
import re
import shlex

import numpy as np
import pytest
import torch

from splendax_torch.eval import duel_replay as dr
from splendax_torch.eval import search_duel
from splendax_torch.models import actor_critic as ac
from test_torch_ladder import by_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "runs", "search_duels")
SCRIPTS = ("round4_duels.sh", "round4_duels2.sh", "round4_headline_evals.sh",
           "round5_censored_league_evals.sh", "round5_league_control_evals.sh")


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def compare():
    return by_path("torch_ladder_compare", "scripts/torch_ladder_compare.py")


def committed(name):
    with open(os.path.join(COMMITTED, name + ".json")) as f:
        return json.load(f)


def expand(text, env):
    return re.sub(r"\$\{(\w+)\}|\$(\w+)", lambda m: env[m.group(1) or m.group(2)], text)


def script_commands(script):
    """(line, runner, argv, json-out name) of each `scripts/search_duel.py` /
    `splendax.eval.cli` command of a round script, its variables expanded:
    a command inside `run_duel` once per call, with the call's arguments."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        lines = f.read().split("\n")
    logical, buf, start = [], "", None
    for n, line in enumerate(lines, 1):
        start = start or n
        if line.endswith("\\"):
            buf += line[:-1] + " "
            continue
        logical.append((start, buf + line))
        buf, start = "", None
    env, func, calls, out = {}, None, [], []
    for n, line in logical:
        text = line.strip()
        if m := re.fullmatch(r"([A-Z0-9_]+)=(.*)", text):
            value = re.sub(r"\$\{1:-([^}]*)\}", r"\1", m.group(2))
            env[m.group(1)] = expand(shlex.split(value)[0], env)
        elif m := re.fullmatch(r"run_duel\s+(\S+)\s+(\S+)\s+(\S+)", text):
            calls.append((n, dict(a=m.group(1), b=m.group(2), tag=m.group(3))))
        elif "scripts/search_duel.py" in text or "splendax.eval.cli" in text:
            if "$a" in text:
                func = text  # run_duel's body
            else:
                out.append((n, text, {}))
    out += [(n, func, args) for n, args in calls]
    parsed = []
    for n, text, args in out:
        words = shlex.split(expand(text, {**env, **args}).split("||")[0])
        runner = "search_duel" if "scripts/search_duel.py" in words else "cli"
        argv = words[words.index("scripts/search_duel.py" if runner == "search_duel"
                                 else "splendax.eval.cli") + 1:]
        i = argv.index("--json-out")
        name = os.path.basename(argv[i + 1])[:-len(".json")]
        parsed.append((n, runner, tuple(argv[:i] + argv[i + 2:]), name))
    return parsed


def test_manifest_is_the_round_scripts():
    """Every command of the five round scripts has an entry with its runner, bots,
    flags, games, seeds and file name, or a left-out reason; every entry
    that names a script is one of its commands."""
    found = set()
    for script in SCRIPTS:
        for line, runner, argv, name in script_commands(script):
            where = f"scripts/{script}:{line}"
            found.add(name)
            if name in dr.LEFT_OUT:
                assert dr.LEFT_OUT[name].startswith(where + ":")
                pt = argv[argv.index("--torch-pt") + 1]
                assert os.path.commonpath([os.path.abspath(pt), ROOT]) != ROOT
                continue
            e = dr.BY_NAME[name]
            assert (e.runner, e.argv, e.source) == (runner, argv, where), name
    from_scripts = {e.name for e in dr.MANIFEST if e.source.startswith("scripts/")}
    assert found == from_scripts | set(dr.LEFT_OUT)
    assert len(found) == 9 + 3 + 2 + 5


def test_every_committed_file_has_an_entry():
    names = sorted(f[:-len(".json")] for f in os.listdir(COMMITTED) if f.endswith(".json"))
    assert len(names) == 25
    assert names == sorted(e.name for e in dr.MANIFEST if e.limit != dr.WRITTEN)
    classes = {c: [e.name for e in dr.MANIFEST if e.limit == c]
               for c in (dr.HELD, dr.REPORTED, dr.WRITTEN)}
    assert [len(classes[c]) for c in (dr.HELD, dr.REPORTED, dr.WRITTEN)] == [19, 6, 2]
    # The reported files are the six without a round suffix, from the older
    # unpaired head-to-head; every held one has a suffix or is a model eval.
    for name in classes[dr.REPORTED]:
        assert not re.search(r"_r[45]", name) and "n_pairs" not in next(iter(
            committed(name).values()))
    for name in classes[dr.HELD]:
        assert re.search(r"_r[45]", name) or dr.BY_NAME[name].runner == "cli"
    for name in classes[dr.WRITTEN]:
        assert not os.path.exists(os.path.join(COMMITTED, name + ".json"))


def test_entries_give_the_committed_keys_and_games():
    """For each duel the port's `search_duel.build` gives the committed key,
    and each entry plays the committed n: 2 x games, seed 1 for `_seed1`."""
    params = ac.ActorCritic(16, device="cpu")
    for e in dr.MANIFEST:
        if e.limit == dr.WRITTEN:
            continue
        (key, res), = committed(e.name).items()
        if e.runner == "search_duel":
            args = search_duel.build_parser().parse_args(list(e.argv))
            tags = [search_duel.build(bot, args, params)[1] for bot in (args.a, args.b)]
            assert key == "_vs_".join(tags), e.name
            assert args.seed == (1 if e.name.endswith("seed1") else 0)
            games = args.games
        else:
            assert key == {"vs-model": "model_vs_model", "vs-basic": "model_vs_basic"}[e.argv[0]]
            assert "--both-seats" in e.argv and res["n_pairs"] * 2 == res["n"]
            games = int(e.argv[e.argv.index("--games") + 1])
        assert 2 * games == res["n"], e.name


def test_replay_on_the_cpu_writes_the_committed_keys(tmp_path, monkeypatch, one_thread):
    """One duel and one model eval at 2 games a seat order: each file holds
    the committed key, n = 4, and is held by z; a second call keeps them."""
    names = ["mc_vs_greedy_h768", "censored_vs_priv_league_s43"]
    argv = [a for n in names for a in ("--only", n)] + ["--games", "2",
                                                         "--out-dir", str(tmp_path)]
    out = dr.main(argv, device="cpu")
    assert list(out["entries"]) == names and out["left_out"] == dr.LEFT_OUT
    for name in names:
        with open(tmp_path / f"{name}.json") as f:
            written = json.load(f)
        assert list(written) == list(committed(name))
        (res,) = written.values()
        assert res["n"] == 4 and res["n_pairs"] == 2 and res["paired_deals"]
        row = out["entries"][name]
        assert row["seconds"] > 0 and [r[0] for r in row["rows"]] == list(written)
        assert row["rows"][0][5] == ("unpaired" if row["limit"] == dr.REPORTED else "paired")
    assert sorted(os.listdir(tmp_path)) == [f"{n}.json" for n in sorted(names)]

    def no_games(*a, **kw):
        raise AssertionError("a written file was replayed")

    monkeypatch.setattr(dr, "play", no_games)
    again = dr.main(argv, device="cpu")
    assert all(r["seconds"] is None for r in again["entries"].values())
    assert [r["rows"] for r in again["entries"].values()] == [
        r["rows"] for r in out["entries"].values()]


def test_committed_replay_holds_every_limit(monkeypatch):
    """The committed replay, `runs/search_duels_torch/`: a file for every
    entry, each kept (nothing replayed), every held and reported file
    compared by z with no limit broken, and every `privileged` flag the
    committed file records equal."""

    def no_games(*a, **kw):
        raise AssertionError("a committed replay file was replayed")

    monkeypatch.setattr(dr, "play", no_games)
    out = dr.main([], device="cpu")
    assert out["broken"] == [] and list(out["entries"]) == [e.name for e in dr.MANIFEST]
    for name, row in out["entries"].items():
        with open(row["file"]) as f:
            (key, res), = json.load(f).items()
        assert row["seconds"] is None and res["paired_deals"] and res["n"] == 2 * res["n_pairs"]
        if row["limit"] == dr.WRITTEN:
            assert row["rows"] == []
            continue
        (ref,) = committed(name).values()
        assert [r[0] for r in row["rows"]] == [key] and res["n"] == ref["n"]
        assert res.get("privileged") == ref.get("privileged", res.get("privileged")), name
    assert set(out["above"]) <= {n for n, r in out["entries"].items() if r["limit"] == dr.HELD}


def test_replay_refuses_the_committed_files(monkeypatch):
    before = {f: open(os.path.join(COMMITTED, f), "rb").read() for f in os.listdir(COMMITTED)}
    monkeypatch.chdir(ROOT)
    for out in ("runs/search_duels", COMMITTED, os.path.join(COMMITTED, "sub"),
                "runs/../runs/search_duels/"):
        with pytest.raises(SystemExit):
            dr.main(["--out-dir", out, "--only", "mc_vs_greedy_h768"], device="cpu")
    for bad in ("refckpt_vs_gumbelgf_r4", "no_such_file"):
        with pytest.raises(SystemExit):
            dr.main(["--only", bad, "--out-dir", os.devnull + "_x"], device="cpu")
    assert {f: open(os.path.join(COMMITTED, f), "rb").read()
            for f in os.listdir(COMMITTED)} == before
    assert dr.build_parser().parse_args([]).out_dir == os.path.join(ROOT, "runs",
                                                                    "search_duels_torch")


def test_comparator_without_n_pairs(compare, tmp_path, capsys):
    """A file of the older unpaired head-to-head: its se floor takes n // 2,
    its row says "unpaired"; --no-limit prints the z and its reason and
    keeps it out of the exit code."""
    path = os.path.join(COMMITTED, "uct_vs_gumbel_h768.json")
    ref = committed("uct_vs_gumbel_h768")
    (key, res), = ref.items()
    assert "n_pairs" not in res
    (row,) = compare.duel_z(ref, ref)
    assert row[0] == key and row[4] == 0.0 and row[5] == "unpaired"
    assert row[3] == max(np.hypot(res["score_ci95"] / 1.96, res["score_ci95"] / 1.96),
                         0.5 / (res["n"] // 2))
    swept = {key: {**res, "score": 1.0, "score_ci95": 0.0}}
    (row,) = compare.duel_z(swept, swept)
    assert row[3] == 0.5 / 100
    assert compare.main(["--duel", path, path]) == 0
    shifted = tmp_path / "shifted.json"
    shifted.write_text(json.dumps({key: {**res, "score": res["score"] - 0.4}}))
    assert compare.main(["--duel", str(shifted), path]) == 1
    capsys.readouterr()
    assert compare.main(["--duel", str(shifted), path, "--no-limit", f"{key}=an older run"]) == 0
    printed = capsys.readouterr().out
    assert "(unpaired)" in printed and "no limit: an older run" in printed
    # A paired port file against an unpaired reference: the floor takes
    # the smaller side's games.
    paired = {key: {**res, "n_pairs": 16, "n": 32, "score_ci95": 0.0}}
    assert compare.duel_z(paired, swept)[0][3] == 0.5 / 16


def test_replay_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dr.main(["--only", "mc_vs_greedy_h768", "--out-dir", os.devnull + "_x"])

"""The port's all-agents Elo ladder (`splendax_torch/eval/ladder.py`), its
search duels (`eval/search_duel.py`) and the ladder comparator
(`scripts/torch_ladder_compare.py`) against the JAX package's scripts
(`scripts/elo_ladder.py`, `scripts/search_duel.py`) and the committed
ladder `runs/elo_ladder.json`: the same pair schedule and seeds, the same
payload and fit, the same roster flags, tags and JSON layout, on the CPU."""

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from splendax_torch.eval import ladder, search_duel
from splendax_torch.eval import suite as tsuite
from splendax_torch.models import actor_critic as ac
from test_torch_rollout import numpy_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "runs", "elo_ladder.json")
PAYLOAD_KEYS = {"labels", "privileged", "pairs", "partial", "elo", "score", "games"}


def by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jladder():
    return by_path("jax_elo_ladder", "scripts/elo_ladder.py")


@pytest.fixture(scope="module")
def compare():
    return by_path("torch_ladder_compare", "scripts/torch_ladder_compare.py")


@pytest.fixture(scope="module")
def committed():
    with open(COMMITTED) as f:
        return json.load(f)


def tiny_net(path, seed, hidden=16):
    np.savez(path, **numpy_params(np.random.RandomState(seed), hidden))
    return str(path)


def fake_result(n_games, k):
    """A head_to_head dict whose numbers depend on the call index k."""
    wins, draws = (3 * k + 1) % (2 * n_games + 1), k % 2
    draws = min(draws, 2 * n_games - wins)
    return {"n": 2 * n_games, "n_pairs": n_games, "wins": wins, "draws": draws,
            "losses": 2 * n_games - wins - draws, "score": (wins + 0.5 * draws) / (2 * n_games),
            "score_ci95": 0.1, "call": k}


def tiny_roster(tmp_path):
    net = tiny_net(tmp_path / "net16.npz", 1)
    net_b = tiny_net(tmp_path / "net16b.npz", 2)
    roster = [("random", "heuristic", "random"), ("basic", "heuristic", "basic"),
              ("noble", "heuristic", "noble"), ("net16", "npz", net)]
    optional = [("net16b", "npz", net_b), ("absent", "npz", str(tmp_path / "absent.npz"))]
    searches = [("mcbot", "search", ("mc", "net16", dict(rollouts=2, horizon=1))),
                ("cmcbot", "search", ("cmc", "net16", dict(rollouts=2, horizon=1)))]
    return roster, optional, searches


def recorder(calls):
    def head_to_head(a, b, n_games, seed=0, **kw):
        calls.append((n_games, seed))
        return fake_result(n_games, len(calls) - 1)
    return head_to_head


def played(payload, prior):
    """(key, games, seed) of each new pair in the order it was played."""
    new = [(v["call"], k) for k, v in payload["pairs"].items() if k not in prior]
    return [k for _, k in sorted(new)]


def test_schedule_and_resume_equal_the_jax_script(tmp_path, monkeypatch, jladder):
    import jax
    import splendax.eval.suite as jsuite
    import splendax.utils.cache as jcache

    roster, optional, searches = tiny_roster(tmp_path)
    prior = {"random:basic": fake_result(3, 99), "ghost:basic": fake_result(3, 98)}
    argv = ["--include-search", "--search-core", "basic,net16", "--games", "3",
            "--search-games", "2", "--seed", "5"]
    got = {}
    for side, mod in (("jax", jladder), ("torch", ladder)):
        out = tmp_path / f"{side}.json"
        with open(out, "w") as f:
            json.dump({"pairs": prior, "privileged": {"ghost": False}}, f)
        calls = []
        monkeypatch.setattr(mod, "ROSTER", roster)
        monkeypatch.setattr(mod, "OPTIONAL_NETS", optional)
        monkeypatch.setattr(mod, "SEARCH_ROSTER", searches)
        if side == "jax":
            monkeypatch.setattr(jsuite, "head_to_head", recorder(calls))
            monkeypatch.setattr(jcache, "setup_runtime", lambda *a: None)
            monkeypatch.setattr(jax, "clear_caches", lambda: None)
            monkeypatch.setattr("sys.argv", ["elo_ladder.py", *argv, "--out", str(out)])
            jladder.main()
        else:
            monkeypatch.setattr(tsuite, "head_to_head", recorder(calls))
            ladder.main([*argv, "--out", str(out)], device="cpu")
        with open(out) as f:
            payload = json.load(f)
        got[side] = (payload, [(k, *c) for k, c in zip(played(payload, prior), calls)])
    (jp, jplayed), (tp, tplayed) = got["jax"], got["torch"]
    assert tplayed == jplayed
    keys = [k for k, *_ in tplayed]
    # Non-search pairs in full (random:basic resumed), search bots only
    # against the core and each other, with the search games and seeds.
    assert len(keys) == 9 + 4 + 1 and "random:basic" not in keys
    assert not any(k.startswith(("mcbot:", "cmcbot:")) and "net16b" in k for k in keys)
    assert ("net16:mcbot", 2, 5 + 1000 * 3 + 5) in tplayed
    assert ("random:noble", 3, 5 + 2) in tplayed
    assert tp["labels"] == jp["labels"] == ["random", "basic", "noble", "net16", "net16b",
                                            "mcbot", "cmcbot", "ghost"]
    assert tp["privileged"] == jp["privileged"]
    assert tp["privileged"]["mcbot"] and not tp["privileged"]["cmcbot"]
    assert not tp["privileged"]["ghost"]
    assert tp["pairs"] == jp["pairs"] and tp["partial"] is jp["partial"] is False
    assert list(tp["elo"]) == list(jp["elo"]) and "ghost" in tp["elo"]
    assert np.allclose(list(tp["elo"].values()), list(jp["elo"].values()), rtol=0, atol=1e-9)
    assert tp["score"] == jp["score"] and tp["games"] == jp["games"]


def test_dump_equals_the_jax_dump_on_the_committed_pairs(tmp_path, jladder, committed):
    from splendax.eval.elo import bradley_terry_elo as jax_bt

    args = (committed["labels"], committed["privileged"], committed["pairs"])
    got = ladder._dump(str(tmp_path / "t.json"), *args, partial=False)
    jladder._dump(str(tmp_path / "j.json"), *args, partial=False, bt=jax_bt)
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert set(got) == set(want) == PAYLOAD_KEYS
    assert list(got["elo"]) == list(want["elo"]) == list(committed["elo"])
    for ref in (want["elo"], committed["elo"]):
        assert max(abs(got["elo"][l] - ref[l]) for l in ref) < 1e-9
    assert got["score"] == want["score"] and got["games"] == want["games"]
    assert got["labels"] == want["labels"] and got["pairs"] == want["pairs"]


def test_roster_from_the_committed_nets(committed):
    roster, policies, privileged = ladder.build_roster(include_search=True, device="cpu")
    labels = [label for label, _, _ in roster]
    # The reference checkpoint is not in the repository; the uncommitted
    # s42 league net was never a roster row.
    assert set(labels) == set(committed["labels"]) - {"reference_ckpt", "ppo_500m_league"}
    search = {label for label, _, _ in ladder.SEARCH_ROSTER}
    assert [l for l in labels if l not in search] == [
        l for l in committed["labels"] if l in labels and l not in search]
    for label in labels:
        assert privileged[label] == committed["privileged"][label], label
    widths = {label: policies[label][1][0].shape[1] for label in
              ("ppo_2b_h256", "ppo_2b_h512", "ppo_2b_h768", "ppo_2b_h1024")}
    assert widths == {"ppo_2b_h256": 256, "ppo_2b_h512": 512, "ppo_2b_h768": 768,
                      "ppo_2b_h1024": 1024}
    assert policies["mc_h768"][1][0].shape[1] == 768


def test_reference_row_only_from_the_checkout(monkeypatch, committed):
    """The `reference_ckpt` row reads its checkpoint only inside the
    checkout; where the file is, the row takes the committed ladder's place,
    so every later label keeps its index and its pairs their seeds."""
    assert os.path.commonpath([ladder.REFERENCE_CKPT, ROOT]) == ROOT
    labels = [l for l, _, _ in ladder.roster_entries(include_search=False)]
    assert "reference_ckpt" not in labels
    exists = os.path.exists
    monkeypatch.setattr(os.path, "exists", lambda p: p == ladder.REFERENCE_CKPT or exists(p))
    with_row = [l for l, _, _ in ladder.roster_entries(include_search=False)]
    at = committed["labels"].index("reference_ckpt")
    assert with_row == labels[:at] + ["reference_ckpt"] + labels[at:]
    assert with_row[:at + 1] == committed["labels"][:at + 1]


def test_mini_ladder_and_its_resume(tmp_path, monkeypatch, committed):
    roster = [("basic", "heuristic", "basic"), ("noble", "heuristic", "noble"),
              ("net_a", "npz", tiny_net(tmp_path / "a.npz", 3)),
              ("net_b", "npz", tiny_net(tmp_path / "b.npz", 4))]
    monkeypatch.setattr(ladder, "ROSTER", roster)
    monkeypatch.setattr(ladder, "OPTIONAL_NETS", [])
    out = str(tmp_path / "mini.json")
    first = ladder.main(["--games", "4", "--seed", "7", "--out", out], device="cpu")
    assert set(first) == PAYLOAD_KEYS and first["partial"] is False
    assert list(first["pairs"]) == ["basic:noble", "basic:net_a", "basic:net_b", "noble:net_a",
                                    "noble:net_b", "net_a:net_b"]
    want_keys = set(next(iter(committed["pairs"].values())))
    for res in first["pairs"].values():
        assert set(res) == want_keys and res["n"] == 8 and res["n_pairs"] == 4
    assert sorted(first["elo"]) == sorted(l for l, _, _ in roster)
    assert np.array(first["games"]).sum() == 6 * 8 * 2

    def no_games(*a, **kw):
        raise AssertionError("a resumed ladder replayed a pair")

    monkeypatch.setattr(tsuite, "head_to_head", no_games)
    again = ladder.main(["--games", "4", "--seed", "7", "--out", out], device="cpu")
    assert again == json.loads(json.dumps(first))


def test_ladder_pair_plays_the_jax_games_on_the_jax_deals():
    """The committed pair noble vs ppo_1750m_wallmatch (H=256) on 48 of the
    deals JAX's ladder dealt it (seed 3017: noble is label 3, the net label
    17 of the committed labels), both seat orders: the port's harness, fed
    those deals as a state, plays JAX's games exactly (final rewards, turns,
    prestige).  The pair's score on the port's own deals then differs from
    JAX's by the deals alone."""
    import jax

    from splendax.env import core as jcore
    from splendax.eval import noble as jnoble  # noqa: F401  (registers "noble")
    from splendax.eval import suite as jsuite
    from splendax.train.checkpoint import import_params_npz as jax_npz
    from splendax_torch.engine import state as S

    n, key = 48, jax.random.PRNGKey(3017)
    npz = ladder.NET("ppo_splendor_1750m_uniform_wallmatch")
    jn, jnet = jsuite.heuristic_policy("noble"), jsuite.model_greedy_policy(jax_npz(npz))
    tn = tsuite.heuristic_policy("noble")
    tnet = tsuite.model_greedy_policy(ac.import_params_npz(npz, device="cpu"))
    jstate, _, _ = jax.vmap(jcore.reset)(jax.random.split(jax.random.split(key)[0], n))
    state = S.from_numpy({k: np.array(getattr(jstate, k)) for k in S.FIELDS}, device="cpu")
    for (ja, jb), (ta, tb) in (((jn, jnet), (tn, tnet)), ((jnet, jn), (tnet, tn))):
        want = jsuite._play_matches(ja[0], ja[1], jb[0], jb[1], n, key, "fast")
        got = tsuite._play_matches(ta[0], ta[1], tb[0], tb[1], n, torch.Generator(), "fast",
                                   state=state)
        assert not np.asarray(want[5]).any() and not got[5].any()
        for name, g, w in zip(("final_r", "turns", "prestige"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert len(set(np.asarray(want[0]).tolist())) > 1  # both sides won games


@pytest.mark.slow
@pytest.mark.parametrize("a,b", [("random", "basic"), ("random", "greedy_v1"),
                                 ("noble", "ppo_1750m_wallmatch")])
def test_ladder_pairs_agree_with_jax_over_many_deals(a, b):
    """Three pairs whose committed scores rest on few games (random's row) or
    whose replay lay far out: each package plays the pair at 16 seeds, 100
    games a seat order (3,200 games), and a's mean points a seed agree within
    4 standard errors.  Prints the points of every seed."""
    from splendax.eval import noble as jnoble  # noqa: F401  (registers "noble")
    from splendax.eval import suite as jsuite
    from splendax.train.checkpoint import import_params_npz as jax_npz

    def pol(pkg, name):
        if name.startswith("ppo_"):
            npz = dict((l, s) for l, _, s in ladder.ROSTER + ladder.OPTIONAL_NETS)[name]
            return (jsuite.model_greedy_policy(jax_npz(npz)) if pkg == "jax" else
                    tsuite.model_greedy_policy(ac.import_params_npz(npz, device="cpu")))
        return (jsuite if pkg == "jax" else tsuite).heuristic_policy(name)

    points = {}
    for pkg, h2h in (("jax", jsuite.head_to_head),
                     ("torch", lambda *x, **k: tsuite.head_to_head(*x, device="cpu", **k))):
        pa, pb = pol(pkg, a), pol(pkg, b)
        points[pkg] = np.array([(lambda r: r["wins"] + 0.5 * r["draws"])(h2h(pa, pb, 100, seed=s))
                                for s in range(1, 17)])
        print(f"{a}:{b} {pkg}: {a}'s points of 200 by seed {points[pkg].tolist()}, "
              f"total {points[pkg].sum()} of 3200")
    se = np.sqrt(sum(p.var(ddof=1) / len(p) for p in points.values()))
    assert abs(points["torch"].mean() - points["jax"].mean()) <= 4 * max(se, 0.5)


def test_refuses_the_committed_ladder(monkeypatch):
    before = open(COMMITTED, "rb").read()
    monkeypatch.chdir(ROOT)
    for out in ("runs/elo_ladder.json", COMMITTED, "runs/../runs/elo_ladder.json"):
        with pytest.raises(SystemExit):
            ladder.main(["--out", out, "--games", "1"], device="cpu")
    assert open(COMMITTED, "rb").read() == before
    assert ladder.build_parser().parse_args([]).out == os.path.join(
        ROOT, "runs", "elo_ladder_torch.json")


def reversed_result(r):
    return {**r, "score": 1.0 - r["score"], "wins": r["losses"], "losses": r["wins"]}


def test_comparator(compare, committed, tmp_path, capsys):
    same = compare.compare(committed, committed)
    assert len(same["rows"]) == len(committed["pairs"]) and same["broken"] == []
    assert all(z == 0.0 for *_, z in same["rows"])
    assert all(abs(p - r) < 1e-9 for _, p, r, *_ in same["elo"])
    # Each key stored the other way round: oriented back, the same numbers.
    flipped = {**committed, "pairs": {":".join(reversed(k.split(":"))): reversed_result(r)
                                      for k, r in committed["pairs"].items()}}
    out = compare.compare(flipped, committed)
    assert len(out["rows"]) == len(committed["pairs"]) and out["broken"] == []
    assert all(abs(z) < 1e-9 for *_, z in out["rows"])
    assert all(abs(p - r) < 1e-6 for _, p, r, *_ in out["elo"])
    # One pair moved by 0.2 is flagged; left out, it is not.
    key = "ppo_2b_h256:ppo_2b_h512"
    moved = json.loads(json.dumps(committed))
    moved["pairs"][key]["score"] += 0.2
    out = compare.compare(moved, committed)
    assert [m for m in out["broken"] if m.startswith(key + ": |z|")]
    assert compare.compare(moved, committed, {key: "a test"})["broken"] == []
    moved["privileged"]["basic"] = True
    assert any(m.startswith("basic: privileged") for m in compare.compare(moved,
                                                                          committed)["broken"])
    # The CLI: 0 within the limits, 1 otherwise.
    path = tmp_path / "moved.json"
    path.write_text(json.dumps(moved))
    assert compare.main([COMMITTED, COMMITTED]) == 0
    assert compare.main([str(path), COMMITTED]) == 1
    assert "BROKEN: " + key in capsys.readouterr().out
    # Duels: keyed by their tags, the same z.
    duel = os.path.join(ROOT, "runs", "search_duels", "gumbelgf_vs_mc_h768_r5paired.json")
    with open(duel) as f:
        ref = json.load(f)
    assert [(r[4], r[5]) for r in compare.duel_z(ref, ref)] == [(0.0, "paired")]
    assert compare.main(["--duel", duel, duel]) == 0
    tag = next(iter(ref))
    shifted = tmp_path / "duel.json"
    shifted.write_text(json.dumps({tag: {**ref[tag], "score": ref[tag]["score"] - 0.3}}))
    assert compare.duel_z(json.loads(shifted.read_text()), ref)[0][4] < -4
    assert compare.main(["--duel", str(shifted), duel]) == 1


class _Parsed(Exception):
    pass


def jax_duel_parser(monkeypatch, jduel):
    seen = {}

    def grab(self, argv=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        jduel.main()
    monkeypatch.undo()
    return seen["parser"]


def test_duel_flags_tags_and_json(tmp_path, monkeypatch):
    from splendax.train.checkpoint import import_params_npz as jax_npz

    jduel = by_path("jax_search_duel", "scripts/search_duel.py")

    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    assert table(search_duel.build_parser()) == table(jax_duel_parser(monkeypatch, jduel))
    npz = tiny_net(tmp_path / "n.npz", 5)
    params, jparams = ac.import_params_npz(npz, device="cpu"), jax_npz(npz)
    for extra in ([], ["--greedy-final", "--rollouts", "3", "--gumbel-m", "8", "--sims", "9"]):
        args = search_duel.build_parser().parse_args(extra)
        for bot in ("mc", "cmc", "gumbel", "cgumbel", "uct", "greedy"):
            assert search_duel.build(bot, args, params)[1] == jduel.build(bot, args, jparams)[1]
    assert search_duel.build("cgumbel", args, params)[1] == "cgumbel(m8,k6,h4,gf)"
    with pytest.raises(SystemExit):
        search_duel.build("greedy", args, None)
    out = tmp_path / "duel.json"
    got = search_duel.main(["--games", "2", "--rollouts", "2", "--horizon", "1",
                            "--json-out", str(out)], device="cpu")
    with open(os.path.join(ROOT, "runs", "search_duels",
                           "gumbelgf_vs_mc_h768_r5paired.json")) as f:
        want = json.load(f)
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(got))
    assert list(written) == ["gumbel(m16,k6,h1)_vs_mc(r2,h1)"]
    res, ref = written["gumbel(m16,k6,h1)_vs_mc(r2,h1)"], next(iter(want.values()))
    assert set(res) == set(ref) and res["n"] == 4 and res["n_pairs"] == 2
    assert set(res["first_seat"]) == set(ref["first_seat"])
    assert res["privileged"] == ref["privileged"] == {"a": True, "b": True}


def test_entry_points_need_the_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (ladder.main, search_duel.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--games", "1"] if main is search_duel.main else ["--games", "1", "--out",
                                                                     os.devnull])

"""The manifest and the files the harness finds by name."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_manifest_has_the_contract_keys_and_nothing_else(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert man["paths"] == ["benchmark"] and man["command"][:2] == ["python3", "-m"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(man)) < 64 * 1024


def test_every_name_and_unit_uses_only_the_allowed_characters(man):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in man[key]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in man["workloads"]] + [
            w["traffic"] for w in man["workloads"]] + [k for c in man["configs"]
                                                       for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in man["configs"]] + [w["why"] for w in man["workloads"]]
                 + [c["why"] for c in man["configs"]] + [m["layer"] for m in man["per_layer"]]
                 + man["command"]):
        assert LINE.match(text), text


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for w in man["workloads"]:
        cell = harness.load_cell(w["name"])
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported, (w["name"], m["name"])


def test_every_cells_files_are_found_by_name(man):
    for w in man["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["config"]["reduced"] == []
        assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers",
                                           cell["traffic"]["kind"] + ".py"))
        assert set(cell["limits"]) >= {"engine"}
        for m in cell["per_layer"]:
            assert callable(harness.reader(m["name"]))
    for c in man["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        conf = harness.read_json(os.path.join(ROOT, c["file"]))
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        for path in [conf["agent"], *conf["frozen_slots"]]:
            assert os.path.exists(os.path.join(ROOT, path)), path


def test_a_new_traffic_file_is_found_with_no_code_edit(tmp_path, man):
    """A copy of the repo's manifest and benchmark folder with one more
    traffic mix and cell, added as files only."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = {"kind": "update", "why": "the slot at twice the rows", "start_update": 3400,
           "recipe": {"search_opponent": True, "search_static": True, "p_search": 0.25}}
    (root / "benchmark" / "traffic" / "league_wide_slot.json").write_text(json.dumps(mix))
    (root / "benchmark" / "limits" / "ac_h768.league_wide_slot.json").write_text(
        (root / "benchmark" / "limits" / "ac_h768.league_static.json").read_text())
    man = dict(man, workloads=man["workloads"] + [
        {"name": "ac_h768.league_wide_slot", "config": "ac_h768", "traffic": "league_wide_slot",
         "chips": 1, "why": "a test's cell"}])
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.load_cell("ac_h768.league_wide_slot", root=str(root))
    assert cell["traffic"] == mix
    assert {m["name"] for m in cell["end_to_end"]} == {"setup_s"}
    from benchmark.drivers import update

    recipe = update.recipe_of(cell)
    assert recipe["p_search"] == 0.25 and recipe["hidden"] == 768


def test_the_configurations_run_the_committed_recipe():
    h768 = harness.read_json(os.path.join(ROOT, "benchmark", "configs", "ac_h768.json"))
    committed = harness.read_json(os.path.join(ROOT, "runs", "ppo_splendor_2b_h768_league",
                                               "config.json"))
    assert h768["recipe"] == committed
    h1024 = harness.read_json(os.path.join(ROOT, "benchmark", "configs", "ac_h1024.json"))
    assert h1024["recipe"] == dict(committed, hidden=1024)

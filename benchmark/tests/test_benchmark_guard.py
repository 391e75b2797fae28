"""The import guard and the refusals before any result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness

ROOT = harness.ROOT
SMALL = {"num_envs": 16, "num_steps": 2, "minibatch_size": 16, "total_timesteps": 3814 * 32}


@pytest.mark.parametrize("modules, found", [
    (["splendax_torch", "splendax_torch.train.ppo", "torch", "numpy"], []),
    (["splendax_torch", "splendax"], ["splendax"]),
    (["splendax.env.core"], ["splendax"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["jaxtyping", "flaxen", "splendaxish"], []),
])
def test_the_guard_compares_whole_top_level_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_a_benchmark_process_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; from benchmark import run; from benchmark.drivers import update, eval; "
            "from benchmark.reference import follow; from benchmark import readings; "
            "from benchmark import harness; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_run_refuses_when_jax_is_loaded_by_the_window(monkeypatch):
    from benchmark import run
    from benchmark.drivers import update

    op = update.Run.op

    def op_loading_jax(self):
        monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("fake"))
        return op(self)

    monkeypatch.setattr(update.Run, "op", op_loading_jax)
    with pytest.raises(run.Forbidden) as e:
        run.measure(harness.load_cell("ac_h768.league_noslot"), 1, 0.01, False, device="cpu",
                    small=SMALL)
    assert e.value.args[0] == ["jaxlib"]


def test_without_a_card_the_run_exits_2_and_prints_no_result():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "ac_h768.league_static", "--seed", "3000000007", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_with_only_the_benchmark_files_the_run_fails_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "ac_h768.league_static", "--seed", "1", "--seconds", "1", "--trace",
                          "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert not any(ln.startswith("{") and "correct" in json.loads(ln) for ln in lines)

"""The port's benchmark (`splendax_torch.bench`): its env step in lockstep
with the root `bench.py`'s jitted rollout, both workloads at tiny shapes on
the CPU, the one-JSON-line CLI, the same work in every update rep, the
league recipe's loader, and no JAX import."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import bench as jbench
import splendax as sx
from splendax.env import ring as jring
from splendax_torch import bench
from splendax_torch.engine import state as S
from splendax_torch.env import ring
from splendax_torch.train import ppo
from splendax_torch.train.config import PPOConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = {"metric", "value", "unit", "vs_baseline", "mean", "backend", "batch", "detail",
            "median", "per_rep", "device", "host", "episodes_finished_last_rep",
            "ring_overflow", "ring_take_launches"}

# The league recipe as the smoke script spelled it out before the loader:
# runs/ppo_splendor_2b_h768_league/config.json without its search slot, and
# the slot's fields.
NO_SLOT = dict(num_envs=8192, num_steps=64, hidden=768, pool_size=12, p_current=0.25,
               reset_ring_mult=2, minibatch_size=32768, update_epochs=4, lr=2.5e-4,
               lr_anneal=True, target_kl=0.02, snapshot_every_updates=16,
               total_timesteps=2_000_000_000, rng_mode="fast")
SLOT = dict(eval_games=256, p_search=0.125, search_m=8, search_k0=4, search_horizon=2)


@pytest.fixture
def one_thread():
    """Tiny eager loops run faster on one intra-op thread, and the suite
    runs several workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_cli(*args):
    out = subprocess.run([sys.executable, "-m", "splendax_torch.bench", *args],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


def test_env_step_matches_jax_bench_in_lockstep(one_thread):
    """128 steps of 32 games through `env_step` on the draws, start states
    and ring of `bench.make_rollout(32, 128, False)`: exactly its end state
    (all 18 fields), mask, games ended, obs sum, reward sum and overflow."""
    B, T = 32, 128
    key = jax.random.PRNGKey(0)
    states, _, masks = sx.reset_batch(jax.random.split(key, B))
    j_states, j_masks, j_done, j_obs, j_rew, j_over = jbench.make_rollout(B, T, False)(
        key, states, masks)

    # The rollout's key schedule, rebuilt.
    k_ring, k_scan = jax.random.split(key)
    jr = jring.make_ring(k_ring, B * 2)
    us = [np.array(jax.random.uniform(jax.random.split(k)[0], (B, 1)))[:, 0]
          for k in jax.random.split(k_scan, T)]

    st = S.from_numpy({k: np.array(getattr(states, k)) for k in S.FIELDS}, device="cpu")
    mask = torch.from_numpy(np.array(masks))
    pr = ring.FreshGameRing(
        packed=torch.from_numpy(np.array(jr.packed)), mask0=torch.from_numpy(np.array(jr.mask0)),
        ptr=torch.tensor(0), overflow=torch.tensor(0), size=B * 2,
    )
    done = obs_sum = 0
    r_sum = torch.zeros(())
    for u in us:
        st, mask, pr, (d, o, r) = bench.env_step(st, mask, pr, u=torch.from_numpy(u))
        done, obs_sum, r_sum = done + int(d), obs_sum + int(o), r_sum + r

    ps = S.to_numpy(st)
    for k in S.FIELDS:
        np.testing.assert_array_equal(ps[k], np.asarray(getattr(j_states, k)), err_msg=k)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_masks))
    assert done == int(j_done) > 0
    assert obs_sum == int(j_obs)
    assert r_sum.item() == float(j_rew)
    assert int(pr.overflow) == int(j_over) == 0


@pytest.mark.parametrize("naive", [False, True], ids=["ring", "naive"])
def test_bench_env_steps_tiny(naive, one_thread):
    r = bench.bench_env_steps(batch=32, steps=4, reps=1, naive=naive, device="cpu")
    assert r["steps_per_sec"] > 0 and r["per_rep"] == [r["steps_per_sec"]]
    assert r["batch"] == 32 and r["scan_steps"] == 4
    assert r["ring_overflow"] == 0 and r["ring_take_launches"] == 0  # plain take on the CPU


def test_bench_env_raises_on_ring_overflow(one_thread):
    """A window of one row clamps every second game that ends in a step."""
    with pytest.raises(RuntimeError, match="ring window overflow"):
        bench.bench_env_steps(batch=64, steps=160, reps=1, device="cpu", window=1)


def test_bench_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench_env_steps(batch=32, steps=4, reps=1)


def test_cli_env_prints_one_json_line():
    line = run_cli("--device", "cpu", "--batch", "32", "--steps", "4", "--reps", "1")
    assert set(line) >= ENV_KEYS
    assert line["metric"] == "env_steps_per_sec_per_chip" and line["unit"] == "steps/s"
    assert line["backend"] == "cpu" and line["device"] == "cpu" and line["batch"] == 32
    assert line["value"] == round(line["per_rep"][0], 1) > 0
    assert line["vs_baseline"] == round(line["value"] / bench.BASELINE_STEPS_PER_SEC, 2)
    assert "eager loop" in line["detail"] and "ring reset" in line["detail"]


def test_cli_update_prints_one_json_line():
    line = run_cli("--workload", "update", "--device", "cpu", "--weights", "random",
                   "--hidden", "32", "--num-envs", "16", "--num-steps", "4", "--slot", "static")
    assert line["metric"] == "agent_steps_per_sec" and line["slot"] == "static"
    assert line["hidden"] == 32 and line["num_envs"] == 16 and line["num_steps"] == 4
    assert len(line["per_rep"]) == len(line["optimizer_steps_per_rep"]) == 3
    assert line["value"] == round(max(line["per_rep"]), 1) > 0
    for rate, s in zip(line["per_rep"], line["seconds_per_rep"]):
        assert rate == pytest.approx(16 * 4 / s)
    assert set(line["split_seconds"]) == {"rollout", "gae", "epochs"}
    assert line["updates_counted"] == 4 and not any(line["launches_per_update"].values())
    assert line["seed"] == 42 and line["update"] == {"update": 1}  # the recipe's seed, update 0 warm


SEARCH_KEYS = {"metric", "value", "unit", "mean", "median", "per_rep", "backend", "device", "host",
               "detail", "seconds_per_rep", "ms_per_move", "turns_played", "agent_moves", "bot",
               "label", "games", "seed", "reps", "win_rate", "illegal_action_rate",
               "peak_memory_bytes", "launches_per_eval", "evals_counted", "hidden"}


def test_cli_search_prints_one_json_line(capsys, one_thread):
    """The search workload at a tiny size: one line, its rate from the
    agent's moves and its ms a move from the turns the loop ran; without
    --bot the CLI refuses."""
    bench.main(["--workload", "search", "--bot", "greedy", "--device", "cpu", "--games", "2",
                "--reps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) >= SEARCH_KEYS
    assert line["metric"] == "search_moves_per_sec" and line["unit"] == "agent moves/s"
    assert line["bot"] == line["label"] == "greedy" and line["games"] == 2 and line["seed"] == 7
    assert line["hidden"] == 768 and line["evals_counted"] == 2
    assert line["illegal_action_rate"] == 0 and 0 <= line["win_rate"] <= 1
    (s,) = line["seconds_per_rep"]
    assert line["value"] == round(line["per_rep"][0], 1) > 0
    assert line["per_rep"][0] == pytest.approx(line["agent_moves"] / s)
    assert line["ms_per_move"] == pytest.approx(s / line["turns_played"] * 1e3)
    assert line["turns_played"] <= line["agent_moves"] <= 2 * line["turns_played"]
    assert not any(line["launches_per_eval"].values())  # the plain forward on the CPU
    with pytest.raises(SystemExit):
        bench.main(["--workload", "search", "--device", "cpu"])
    assert "needs --bot" in capsys.readouterr().err


def test_search_bots_are_time_search_s():
    """The bots' names and privileged flags are those of
    scripts/time_search.py's bots built by the JAX package on the same npz
    (building either compiles nothing), and every bot shares one handle."""
    from splendax.eval import suite as jsuite
    from splendax.search import gumbel_search_policy, mc_search_policy, uct_search_policy
    from splendax.train.checkpoint import import_params_npz as jax_npz
    from splendax_torch.eval import suite as tsuite
    from splendax_torch.models.actor_critic import import_params_npz

    npz = os.path.join(ROOT, bench.AGENT_NPZ)
    jparams = jax_npz(npz)
    jax_bots = {"mc(r8,h4)": mc_search_policy(8, 4, jparams),
                "gumbel(m16,k6,h4)": gumbel_search_policy(m=16, k0=6, horizon=4, params=jparams),
                "uct(s64)": uct_search_policy(64, params=jparams),
                "greedy": jsuite.model_greedy_policy(jparams)}
    bots = bench.search_bots(import_params_npz(npz, device="cpu"))
    assert tuple(bots) == bench.SEARCH_BOTS
    assert [label for label, _ in bots.values()] == list(jax_bots)
    for label, spec in bots.values():
        want = jax_bots[label]
        assert spec[0].__name__ == want[0].__name__, label
        assert tsuite.is_privileged(spec) == jsuite.is_privileged(want), label
    assert len({id(spec[1]) for _, spec in bots.values()}) == 1


def test_update_reps_do_the_same_work(one_thread):
    """Two reps from one saved state take the same optimizer steps and
    leave the same params, bit for bit, as an update of a fresh state."""
    cfg = bench.league_config("static").replace(hidden=32, num_envs=16, num_steps=4, seed=5)
    saved = bench.save_state(ppo.init_train_state(cfg, device="cpu"))
    runs = bench.timed_updates(cfg, saved, 2)
    fresh, _ = ppo.update_step(cfg, ppo.init_train_state(cfg, device="cpu"))
    assert runs[0]["optimizer_steps"] == runs[1]["optimizer_steps"] > 0
    assert runs[0]["metrics"] == runs[1]["metrics"]
    for a, b, c, d in zip(runs[0]["params"], runs[1]["params"], fresh.params.parameters(),
                          saved[0].params.parameters()):
        assert torch.equal(a, b) and torch.equal(a, c) and not torch.equal(a, d)


@pytest.mark.parametrize("slot", list(bench.SLOTS))
def test_league_config_is_the_recipe(slot):
    cfg = bench.league_config(slot)
    for k, v in dict(NO_SLOT, **SLOT).items():
        assert getattr(cfg, k) == v, k
    flags = (cfg.search_opponent, cfg.search_static, cfg.search_censored)
    assert flags == {"none": (False, False, False), "bernoulli": (True, False, False),
                     "static": (True, True, False), "static_cens": (True, True, True)}[slot]
    if slot == "static":
        assert cfg.n_search_static == 1024 and cfg.search_stride == 8
    assert cfg.replace(**bench.SLOTS["none"]) == bench.league_config("none")
    assert PPOConfig(**NO_SLOT).batch_size == cfg.batch_size


def test_committed_update_is_one_the_run_took_whole():
    """The committed nets' timed update is the agent run's update 3,812:
    the schedule's last lr above 0, as its metrics.jsonl logged it, with a
    KL under the stop (so the run took all 64 optimizer steps there)."""
    cfg = bench.league_config("static")
    at = bench.committed_update(cfg)
    assert at["update"] == cfg.num_updates - 2 == 3812
    assert at["lr"] == ppo._anneal(cfg, 3812)[0] > 0
    assert at["lr"] == pytest.approx(at["logged_lr"], rel=1e-3)
    assert abs(at["logged_approx_kl"]) < cfg.target_kl
    with open(os.path.join(ROOT, bench.AGENT_METRICS)) as f:
        logged = [json.loads(x) for x in f if '"train"' in x][3812]
    assert (logged["lr"], logged["approx_kl"]) == (at["logged_lr"], at["logged_approx_kl"])


def test_committed_weights_keep_the_recipes_shape():
    with pytest.raises(RuntimeError, match="recipe's shape"):
        bench.bench_update("none", "committed", num_envs=16, device="cpu")


def test_flagship_state_full_pool(one_thread):
    """With `full_pool` every frozen slot holds a net: the two committed
    frozen nets, then the agent, as the recipe's pool is full from update
    192 on; opponents are drawn over all 12 and CURRENT."""
    cfg = bench.league_config("none").replace(num_envs=256, num_steps=4)
    ts = bench.flagship_state(cfg, "cpu", full_pool=True)
    pool = ts.pool
    assert pool.filled == pool.pool_size == 12 and pool.n_snapshots == 12
    assert not torch.equal(pool.stack[0][0], pool.stack[0][2])
    for i in range(2, 12):
        assert torch.equal(pool.stack[0][i], pool.stack[0][12])  # CURRENT holds the agent
    assert set(ts.opp_idx.tolist()) == set(range(13))
    assert bench.flagship_state(cfg, "cpu").pool.filled == 2


def test_derived_modes_counts_the_mode_each_b_derives(monkeypatch):
    """Inside `derived_modes` a forward whose mode the wrapper picks adds
    the mode its B and H derive; one that names its mode adds nothing;
    on leaving, `_launch` is what it was."""
    from splendax_torch.ops import fused_actor_critic as fac

    calls = []
    monkeypatch.setattr(fac, "_launch", lambda *a: calls.append(a))
    bench.zero_launches()
    w = [torch.zeros(297, 768)]
    with bench.derived_modes():
        for b in (512, 8192):
            fac._launch("wgmma", w, torch.zeros(b, 297), None, True)
        fac._launch("wgmma", w, torch.zeros(512, 297), None, True, None, None, "tile")
        fac._launch("wide", [torch.zeros(297, 1024)], torch.zeros(1024, 297), None, False)
    assert len(calls) == 4
    n = bench.read_launches()
    assert (n["derived_cluster"], n["derived_tile"]) == (1, 1)
    assert n["derived_wide_" + fac.wide_mode(1024, 1024, False)] == 1
    assert fac._launch.__name__ == "<lambda>"
    bench.zero_launches()


def test_derived_prep_counts_what_the_weights_call_for(monkeypatch):
    """Inside `derived_modes` a forward on a plain list adds one
    preparation; one on a `PreparedWeights` handle adds one only while the
    handle is stale (before its first preparation, after a write to a
    weight it read); a forward given its buffer or on no rows adds none."""
    from splendax_torch.ops import fused_actor_critic as fac

    def launch(r, weights, obs, mask, with_value, prepared=None, lib=None, mode=None):
        if isinstance(weights, fac.PreparedWeights) and prepared is None:
            weights.buffer()

    monkeypatch.setattr(fac, "_launch", launch)
    bench.zero_launches()
    rng = np.random.RandomState(0)
    w = [torch.as_tensor(rng.rand(*s).astype(np.float32)) for s in
         [(297, 16), (16,), (16, 16), (16,), (16, 45), (45,)] * 2]
    h = fac.PreparedWeights(w)
    obs = torch.zeros(4, 297)
    with bench.derived_modes():
        fac._launch("wgmma", w, obs, None, True)
        fac._launch("wgmma", h, obs, None, True)
        fac._launch("wgmma", h, obs, None, False)
        w[2].add_(1.0)
        fac._launch("wide", h, obs, None, True)
        fac._launch("wgmma", h, obs, None, True)
        fac._launch("wgmma", w, obs, None, True, torch.zeros(1))
        fac._launch("wgmma", w, torch.zeros(0, 297), None, True)
    assert bench.read_launches()["derived_prep"] == 3 and h.preparations == 2
    n = dict(dict.fromkeys(bench.read_launches(), 0), fused_actor_critic=3,
             fused_actor_critic_wgmma=3, fused_actor_critic_cluster=3, derived_cluster=3,
             fused_actor_critic_prep=3, derived_prep=3)
    bench.check_route("plain", n)
    with pytest.raises(RuntimeError, match="prepared its weights 2 times"):
        bench.check_route("plain", dict(n, fused_actor_critic_prep=2))
    bench.zero_launches()


def test_bench_imports_no_jax():
    code = ("import sys, splendax_torch.bench; "
            "bad = [m for m in sys.modules if m == 'jax' or m.split('.')[0] == 'splendax']; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr

"""The port's checkpoints (`train.checkpoint`) and train driver
(`train.train`): round trips, resume equivalence, forward compatibility,
the npz export read by the JAX package, the CLI's defaults against the JAX
CLI's, and a tiny training run on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from splendax.models import actor_critic as jac
from splendax.train import checkpoint as jckpt
from splendax.train import train as jtrain
from splendax_torch.models import actor_critic as ac
from splendax_torch.train import checkpoint as ckpt_lib
from splendax_torch.train import logging_utils, ppo, train
from splendax_torch.train.checkpoint import CheckpointManager
from splendax_torch.train.config import PPOConfig


def tiny_cfg(**kw):
    base = dict(num_envs=16, num_steps=8, hidden=32, pool_size=3, minibatch_size=32,
                update_epochs=2, total_timesteps=16 * 8 * 8, snapshot_every_updates=1,
                lr_anneal=True, opponent_sampling="pfsp", seed=2)
    base.update(kw)
    return PPOConfig(**base)


def flat_tensors(ts):
    """Every tensor and counter of a TrainState, by name."""
    d = ckpt_lib.state_dict(ts)
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(f"{prefix}.{i}", v)
        else:
            out[prefix] = x

    walk("ts", d)
    return out


def assert_states_equal(a, b):
    fa, fb = flat_tensors(a), flat_tensors(b)
    assert set(fa) == set(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_checkpoint_round_trip(tmp_path):
    """Save then restore over a fresh state of another seed: every tensor,
    the generator's state and the counters come back equal, and the 18
    game-state fields are all in the file."""
    cfg = tiny_cfg()
    ts = ppo.init_train_state(cfg, device="cpu")
    for _ in range(2):
        ts, _ = ppo.update_step(cfg, ts)
    mgr = CheckpointManager(str(tmp_path), run_ts="20260101_000000")
    assert not mgr.has_checkpoint()
    latest, stamped = mgr.save_checkpoint(ts, step=256)
    assert latest == mgr.latest_path == str(tmp_path / "ppo_splendor_latest.pt")
    assert stamped == str(tmp_path / "checkpoints" / "ppo_splendor_20260101_000000_256.pt")
    assert mgr.has_checkpoint() and os.path.isfile(stamped)
    saved = torch.load(latest, weights_only=True)
    assert len(saved["env_state"]) == 18 and len(saved["opt_state"]["mu"]) == 12
    fresh = ppo.init_train_state(cfg.replace(seed=99), device="cpu")
    back = mgr.restore_checkpoint(fresh)
    assert_states_equal(back, ts)
    assert back.update_idx == 2 and back.pool.n_snapshots == 2 and back.opt_state.count > 0
    assert torch.equal(back.generator.get_state(), ts.generator.get_state())


def test_resume_equivalence(tmp_path):
    """Exact on the CPU: 2 updates, save, restore into a fresh state, 2 more
    == 4 updates in one go (params, moments, pool, games, generator)."""
    cfg = tiny_cfg()
    straight = ppo.init_train_state(cfg, device="cpu")
    for _ in range(4):
        straight, m_straight = ppo.update_step(cfg, straight)
    ts = ppo.init_train_state(cfg, device="cpu")
    for _ in range(2):
        ts, _ = ppo.update_step(cfg, ts)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_checkpoint(ts)
    resumed = mgr.restore_checkpoint(ppo.init_train_state(cfg, device="cpu"))
    for _ in range(2):
        resumed, m_resumed = ppo.update_step(cfg, resumed)
    assert_states_equal(resumed, straight)
    for k in m_straight:
        assert torch.equal(m_straight[k], m_resumed[k]), k


def test_restore_old_checkpoint_without_pool_stats(tmp_path):
    """Forward compatible: a file written before the PFSP stats (and the
    optimizer's count) existed restores with those at their fresh values
    and everything else from the file."""
    cfg = tiny_cfg()
    ts = ppo.init_train_state(cfg, device="cpu")
    ts, _ = ppo.update_step(cfg, ts)
    old = ckpt_lib.state_dict(ts)
    del old["pool"]["wins"], old["pool"]["games"], old["opt_state"]["count"]
    path = str(tmp_path / "old.pt")
    torch.save(old, path)
    back = CheckpointManager(str(tmp_path)).restore_checkpoint(
        ppo.init_train_state(cfg, device="cpu"), path=path)
    assert back.pool.games.sum() == 0 and back.opt_state.count == 0
    assert back.update_idx == 1 and back.pool.n_snapshots == 1
    for a, b in zip(back.params.parameters(), ts.params.parameters()):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(back.opt_state.mu, ts.opt_state.mu))


def test_restore_a_checkpoint_written_on_another_device_kind(tmp_path, capsys):
    """A CUDA generator's state is 16 bytes, a CPU one's 5,056: such a file
    restores everything else and leaves the fresh random stream."""
    cfg = tiny_cfg()
    ts = ppo.init_train_state(cfg, device="cpu")
    ts, _ = ppo.update_step(cfg, ts)
    other = ckpt_lib.state_dict(ts)
    other["generator"] = torch.zeros(16, dtype=torch.uint8)
    path = str(tmp_path / "other.pt")
    torch.save(other, path)
    fresh = ppo.init_train_state(cfg.replace(seed=5), device="cpu")
    stream = fresh.generator.get_state()
    back = CheckpointManager(str(tmp_path)).restore_checkpoint(fresh, path=path)
    assert "generator state" in capsys.readouterr().out
    assert torch.equal(back.generator.get_state(), stream)
    assert back.update_idx == 1 and torch.equal(back.obs, ts.obs)
    assert all(torch.equal(a, b) for a, b in zip(back.params.parameters(), ts.params.parameters()))


def test_export_npz_is_read_by_the_jax_package(tmp_path):
    """The port's npz loads with the JAX package's `import_params_npz` and
    gives the same forward (rtol/atol 1e-5), and reloads into the port
    exactly."""
    model = ac.ActorCritic(32, torch.Generator().manual_seed(5), "cpu")
    path = str(tmp_path / "sub" / "params.npz")
    ckpt_lib.export_params_npz(model, path)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            f"{h}.{i}.{p}" for h in ("actor", "critic") for i in range(3) for p in "wb")
        assert data["actor.0.w"].shape == (297, 32) and data["critic.2.w"].shape == (32, 1)
    obs = np.random.RandomState(0).randint(0, 8, (40, 297)).astype(np.int32)
    jlogits, jvalue = jac.forward(jckpt.import_params_npz(path), jnp.asarray(obs))
    logits, value = model(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue), rtol=1e-5, atol=1e-5)
    again = ac.import_params_npz(path, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))


def test_parse_args_defaults_equal_the_jax_cli():
    """`parse_args([])` and a line with every flag set give the same
    PPOConfig field values in both packages."""
    line = ("--total-timesteps 4096 --num-envs 32 --num-steps 16 --gamma 0.99 --gae-lambda 0.9 "
            "--lr 1e-3 --ent-coef 0.02 --vf-coef 0.4 --clip-coef 0.1 --update-epochs 3 "
            "--minibatch-size 64 --seed 7 --log-dir /x --eval-every-updates 3 --eval-games 20 "
            "--lr-anneal --train-opponent greedy_v1 --no-self-play --pool-size 5 "
            "--snapshot-every-updates 4 --p-current 0.5 --target-kl 0.03 --vclip 0.3 "
            "--ent-coef-final 0.0 --hidden 64 --reference-entropy-quirk "
            "--checkpoint-every-updates 2 --resume --profile-updates 1 "
            "--opponent-sampling pfsp --p-search 0.2 --search-m 4 --search-k0 2 "
            "--search-horizon 3 --search-static --search-censored --search-opponent "
            "--rng-mode parity --dp 2 --tp 2 --track --wandb-project-name p --wandb-entity e")
    for argv in ([], line.split()):
        want = dataclasses.asdict(jtrain.parse_args(argv))
        got = dataclasses.asdict(train.parse_args(argv))
        assert got == want


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"], ["--dp", "2", "--tp", "2"]])
def test_flags_of_unported_parts_parse_then_raise(tmp_path, flags):
    """--dp and --tp parse into the config, and in one process `train`
    raises the mesh's ValueError: the mesh needs dp * tp ranks (the
    multi-rank runs are in test_torch_parallel.py)."""
    cfg = train.parse_args(flags + ["--log-dir", str(tmp_path)])
    assert (cfg.dp, cfg.tp) == (int(flags[flags.index("--dp") + 1]) if "--dp" in flags else 0,
                                int(flags[flags.index("--tp") + 1]) if "--tp" in flags else 1)
    n = max(cfg.dp, 1) * cfg.tp
    with pytest.raises(ValueError, match=f"needs {n} ranks, have 1"):
        train.train(cfg, device="cpu")


@pytest.mark.parametrize("flags", [["--search-opponent", "--p-search", "0.5"],
                                   ["--search-opponent", "--search-static", "--search-censored"],
                                   ["--rng-mode", "parity"]])
def test_league_slot_and_parity_flags_train(tmp_path, flags):
    """The league slot's flags and `--rng-mode parity` train through
    `train()`: two updates of 8 x 8 on the CPU, metrics finite."""
    cfg = train.parse_args(flags + [
        "--num-envs", "8", "--num-steps", "8", "--hidden", "16", "--total-timesteps", "128",
        "--minibatch-size", "32", "--update-epochs", "1", "--eval-every-updates", "99",
        "--eval-games", "2", "--search-m", "4", "--search-k0", "1", "--search-horizon", "1",
        "--log-dir", str(tmp_path)])
    ts = train.train(cfg, device="cpu")
    assert ts.update_idx == 2
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    losses = [r["policy_loss"] + r["value_loss"] for r in rows if r["type"] == "train"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    with open(tmp_path / "config.json") as f:
        saved = json.load(f)
    assert saved["rng_mode"] == cfg.rng_mode and saved["search_opponent"] == cfg.search_opponent


def test_hidden_past_1024_parses_and_rolls_out(tmp_path):
    """`--hidden 1280` (wider than the 1024 the port's card path once
    refused; JAX's `--hidden` has no bound) parses as in the JAX CLI, and
    one self-play turn of 4 games runs at that width on the CPU: the agent's
    values equal JAX's forward of the same params on the turn's obs within
    rtol/atol 1e-5, and its log-probs are finite."""
    argv = ["--hidden", "1280", "--num-envs", "4", "--num-steps", "1", "--pool-size", "2",
            "--log-dir", str(tmp_path)]
    cfg = train.parse_args(argv)
    assert cfg.hidden == 1280 and dataclasses.asdict(cfg) == dataclasses.asdict(
        jtrain.parse_args(argv))
    ts = ppo.init_train_state(cfg, device="cpu")
    assert ac.kernel_weights(ts.params)[2].shape == (1280, 1280)
    _, traj = ppo.rollout(cfg, ts)
    assert traj.value.shape == (1, 4) and torch.isfinite(traj.logp).all()
    path = str(tmp_path / "params.npz")
    ckpt_lib.export_params_npz(ts.params, path)
    _, jvalue = jac.forward(jckpt.import_params_npz(path), jnp.asarray(traj.obs[0].numpy()))
    np.testing.assert_allclose(traj.value[0].numpy(), np.asarray(jvalue), rtol=1e-5, atol=1e-5)


def test_train_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train(PPOConfig(log_dir=str(tmp_path)))


def test_tiny_train_run_writes_its_files_and_resumes(tmp_path, capsys):
    """4 updates of 16 x 16 on the CPU through `train()`: config.json,
    metrics.jsonl (4 train records, 3 evals of 4 opponents), the latest and
    timestamped checkpoints, an npz equal to the trained params that the
    JAX package loads; a resumed run starts at update 4 and does none."""
    log_dir = str(tmp_path / "run")
    cfg = train.parse_args(["--total-timesteps", "1024", "--num-envs", "16", "--num-steps", "16",
                            "--eval-games", "8", "--eval-every-updates", "2", "--hidden", "32",
                            "--minibatch-size", "64", "--log-dir", log_dir])
    ts = train.train(cfg, device="cpu")
    assert ts.update_idx == 4 and ts.global_step == 1024
    out = capsys.readouterr().out
    assert "[device]" in out and "Running initial evaluation" in out
    for name in ("random", "greedy_v1", "basic", "self"):
        assert f"vs {name}: wr=" in out
    with open(os.path.join(log_dir, "config.json")) as f:
        assert json.load(f) == dataclasses.asdict(cfg)
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["type"] == "train"] == [256, 512, 768, 1024]
    evals = [r for r in recs if r["type"] == "eval"]
    assert [r["step"] for r in evals] == [0, 512, 1024]
    assert all(r[name]["n"] == 8 and r[name]["illegal_action_rate"] == 0
               for r in evals for name in ("random", "greedy_v1", "basic", "self"))
    assert os.path.isfile(os.path.join(log_dir, "ppo_splendor_latest.pt"))
    assert len(os.listdir(os.path.join(log_dir, "checkpoints"))) == 3  # final + 2 evals
    npz = os.path.join(log_dir, "ppo_splendor_params.npz")
    again = ac.import_params_npz(npz, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), ts.params.parameters()))
    assert np.asarray(jckpt.import_params_npz(npz)["actor"][0]["w"]).shape == (297, 32)

    calls = []
    resumed = train.train(cfg.replace(resume=True), eval_fn=lambda p, s: calls.append(s) or {},
                          device="cpu")
    assert "[resume] restored update 4" in capsys.readouterr().out
    assert resumed.update_idx == 4 and calls == []
    assert_states_equal(resumed, ts)


def test_logging_copy_matches_the_original():
    """The port keeps its own copy of the logging module: same classes and
    the same schedule."""
    from splendax.train import logging_utils as jlog

    assert logging_utils.linear_lr_schedule(2e-4, 0.25) == jlog.linear_lr_schedule(2e-4, 0.25)
    assert ([f.name for f in dataclasses.fields(logging_utils.TrainingHistory)]
            == [f.name for f in dataclasses.fields(jlog.TrainingHistory)])
    public = lambda c: {n for n in vars(c) if not n.startswith("_")}  # noqa: E731
    assert public(logging_utils.TrainingLogger) == public(jlog.TrainingLogger)


def test_profile_updates_writes_a_trace(tmp_path):
    """--profile-updates N: one warm-up update, then N under torch.profiler
    into <log_dir>/profile; training goes on from there.  The trace holds the
    program's spans on the profiler's timeline: the traced update's span
    holds every operation the profiler saw in it."""
    log_dir = str(tmp_path / "run")
    cfg = train.parse_args(["--total-timesteps", "512", "--num-envs", "8", "--num-steps", "16",
                            "--eval-every-updates", "100", "--hidden", "16", "--profile-updates", "1",
                            "--log-dir", log_dir])
    ts = train.train(cfg, eval_fn=lambda params, seed: {}, device="cpu")
    path = os.path.join(log_dir, "profile", "trace.json")
    assert os.path.getsize(path) > 0
    assert ts.update_idx == 4 + 2  # the warm-up and the traced update come on top, as in JAX
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (update,) = [e for e in events if e.get("cat") == "splendax_torch" and e["name"] == "update"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert len(ops) > 100
    lo, hi = update["ts"], update["ts"] + update["dur"]
    eps = 0.002  # the trace's microseconds carry three decimals
    assert all(lo - eps <= e["ts"] and e["ts"] + e["dur"] <= hi + eps for e in ops)
    spans = {e["args"]["path"] for e in events if e.get("cat") == "splendax_torch"}
    assert {"update/rollout/engine.ply", "update/epochs/epochs.step"} <= spans

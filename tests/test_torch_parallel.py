"""The port's dp x tp training over torch.distributed, on gloo ranks on the
CPU: the counterparts of tests/test_multidevice.py, and direct holds of the
ring take and the dp epochs against the JAX package.

The ranks are processes of their own (`parallel.multihost.spawn`), a fleet
of 2 and one of 4 that serve every test of this module
(`_torch_parallel_ranks`, which imports no JAX); the single-process and JAX
references are computed here.  Tolerances are JAX's own for a sharded
update against an unsharded one (params rtol 2e-5 / atol 2e-6, loss rel
1e-4); rollouts, env rows, the ring take and resumes are bit-exact.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

import _torch_parallel_ranks as ranks
from splendax.env import ring as jring
from splendax.parallel import mesh as jmesh
from splendax.train import ppo as jppo
from splendax.train.config import PPOConfig as JPPOConfig
from splendax_torch.engine import state as S
from splendax_torch.env import core
from splendax_torch.env import ring as ring_lib
from splendax_torch.parallel import bench_scaling, dryrun, multihost
from splendax_torch.parallel import mesh as mesh_lib
from splendax_torch.search import gumbel
from splendax_torch.search.ismc import determinize
from splendax_torch.selfplay.opponents import uniform_legal_action
from splendax_torch.train import ppo
from splendax_torch.train.config import PPOConfig
from test_torch_learner import (adam_state_of, jax_leaves_as_torch_order, jax_params,
                                numpy_batch, numpy_params)

TINY = dict(total_timesteps=256, num_envs=16, num_steps=4, minibatch_size=16, pool_size=2,
            seed=0, hidden=32)
LEAGUE = dict(search_opponent=True, search_static=True, p_search=0.25, search_m=4, search_k0=1,
              search_horizon=1)


@pytest.fixture(scope="module")
def fleets():
    made = {}

    def get(world):
        if world not in made:
            made[world] = ranks.Fleet(world)
        return made[world]

    yield get
    for fleet in made.values():
        fleet.close()


def single_update(kw, n_updates=1):
    cfg = PPOConfig(**kw)
    ts = ppo.init_train_state(cfg, device="cpu")
    for _ in range(n_updates):
        ts, metrics = ppo.update_step(cfg, ts)
    return ts, metrics


def assert_params_close(got, want, rtol=2e-5, atol=2e-6):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_dp_update_matches_single_process(fleets):
    """dp=2: the same update as one process (JAX's tolerances), and both
    ranks hold the same params bit for bit."""
    ts, m = single_update(TINY)
    outs = fleets(2).call(ranks.update, TINY, 2, 1)
    want = [p.detach().numpy() for p in ts.params.parameters()]
    for out in outs:
        assert_params_close(out["params"], want)
        assert out["metrics"]["loss"] == pytest.approx(m["loss"].item(), rel=1e-4)
        assert out["count"] == ts.opt_state.count
    assert all(np.array_equal(a, b) for a, b in zip(outs[0]["params"], outs[1]["params"]))


def test_league_update_dp_tp_matches_single_process(fleets):
    """The static league slot on dp=2 x tp=2 equals one process: params,
    loss, and every game's opponent slot."""
    kw = dict(TINY, **LEAGUE)
    assert PPOConfig(**kw).search_stride == 4
    ts, m = single_update(kw)
    outs = fleets(4).call(ranks.update, kw, 2, 2)
    assert_params_close(outs[0]["params"], [p.detach().numpy() for p in ts.params.parameters()])
    assert outs[0]["metrics"]["loss"] == pytest.approx(m["loss"].item(), rel=1e-4)
    opp = np.concatenate([o["opp_idx"] for o in outs if o is outs[2 * o["dp_rank"]]])
    np.testing.assert_array_equal(opp, ts.opp_idx.numpy())


@pytest.mark.parametrize("extra,dp,tp", [
    ({}, 2, 1),
    (dict(search_opponent=True, p_search=0.5, search_m=4, search_k0=1, search_horizon=1,
          opponent_sampling="pfsp", search_censored=True), 4, 1),
    (dict(self_play=False, train_opponent="basic", reset_ring_mult=0), 2, 1),
    (dict(LEAGUE, reset_ring_mult=1), 2, 2),
], ids=["ring", "bernoulli-censored-pfsp", "heuristic-full-batch", "static-slot-tp"])
def test_rollout_rows_equal_single_process(extra, dp, tp, fleets):
    """Each rank's rollout is its rows of the single process's, bit for bit:
    actions, log-probs, rewards, dones, the next obs and opponent slots,
    the ring's overflow and the PFSP counts (summed over dp)."""
    kw = dict(num_envs=16, num_steps=48, pool_size=2, seed=1, hidden=32, **extra)
    cfg = PPOConfig(**kw)
    ts, traj = ppo.rollout(cfg, ppo.init_train_state(cfg, device="cpu"))
    assert int(traj.done.sum()) > 0
    n = cfg.num_envs // dp
    for out in fleets(dp * tp).call(ranks.rollout, kw, dp, tp):
        rows = slice(out["dp_rank"] * n, (out["dp_rank"] + 1) * n)
        for k in ("action", "logp", "reward", "done"):
            np.testing.assert_array_equal(out[k], getattr(traj, k).numpy()[:, rows], err_msg=k)
        np.testing.assert_array_equal(out["obs"], ts.obs.numpy()[rows])
        np.testing.assert_array_equal(out["opp_idx"], ts.opp_idx.numpy()[rows])
        np.testing.assert_array_equal(out["games"], ts.pool.games.numpy())
        np.testing.assert_array_equal(out["wins"], ts.pool.wins.numpy())
        assert int(out["overflow"]) == int(traj.overflow)


def test_env_rows_equal_single_process(fleets):
    """`step_autoreset_ring` on two ranks' rows (the ring whole on each,
    the take counting the other rank's done games): every ply's rows equal
    the single process's, and so do the ring's counters."""
    n, plies, seed = 16, 160, 5
    g = torch.Generator().manual_seed(seed)
    state, _, mask = core.reset(n, g, "cpu")
    ring = ring_lib.make_ring(2 * n, g, "cpu", window=n)
    want = {"obs": [], "mask": [], "reward": [], "terminated": []}
    for _ in range(plies):
        action = uniform_legal_action(mask, u=torch.rand(n, generator=g))
        state, out, obs, mask, ring = ring_lib.step_autoreset_ring(state, action, ring, mask=mask)
        for k, v in (("obs", obs), ("mask", mask), ("reward", out.reward),
                     ("terminated", out.terminated)):
            want[k].append(v.numpy())
    assert sum(int(t.sum()) for t in want["terminated"]) > 2
    final = S.to_numpy(state)
    for r, out in enumerate(fleets(2).call(ranks.env_rows, n, plies, seed)):
        rows = slice(r * n // 2, (r + 1) * n // 2)
        for k, v in want.items():
            np.testing.assert_array_equal(out[k], np.stack(v)[:, rows], err_msg=k)
        for k in S.FIELDS:
            np.testing.assert_array_equal(out["state"][k], final[k][rows], err_msg=k)
        assert (out["ptr"], out["overflow"]) == (int(ring.ptr), int(ring.overflow))


def test_ring_take_over_two_ranks_matches_jax(fleets):
    """The port's take on two ranks' halves of a done vector, concatenated,
    equals JAX's `ring.take` on the whole vector: the fresh games, the mask,
    `ptr` and `overflow`, also when more games end than the window holds."""
    B = 16
    for window, p_done, ptr in ((16, 0.3, 5), (8, 0.9, 30)):
        jr = jring.make_ring(jax.random.PRNGKey(3), 2 * B, window=window)
        jr = jr.replace(ptr=jnp.int32(ptr))
        done = np.random.RandomState(window).rand(B) < p_done
        jfresh, jmask, jr2 = jring.take(jr, jnp.asarray(done))
        outs = fleets(2).call(ranks.ring_take, np.array(jr.packed), np.array(jr.mask0), 2 * B,
                              ptr, done)
        for k in S.FIELDS:
            got = np.concatenate([o["state"][k] for o in outs])
            want = np.asarray(getattr(jfresh, k))
            np.testing.assert_array_equal(got[done], want[done], err_msg=k)
        np.testing.assert_array_equal(np.concatenate([o["mask"] for o in outs]), np.asarray(jmask))
        for o in outs:
            assert (o["ptr"], o["overflow"]) == (int(jr2.ptr), int(jr2.overflow))
    assert int(jr2.overflow) > 0  # the second case overflowed the window


@pytest.mark.parametrize("target_kl", [0.0, 0.01])
def test_dp_epochs_match_jax(target_kl, fleets):
    """The port's epochs on two ranks' rows of JAX's batch, with JAX's
    permutations, equal JAX's `_ppo_epochs` on a dp=2 mesh of virtual
    devices: params and first moments rtol 1e-4 / atol 1e-6, metrics 1e-5,
    the same Adam count (the KL stop at 0.01 ends each epoch early)."""
    rng = np.random.RandomState(6)
    flat = numpy_params(rng, 32)
    T, N = 8, 16
    batch = numpy_batch(rng, flat, T * N, logp_shift=0.05, logp_noise=0.01)
    kw = dict(num_envs=N, num_steps=T, hidden=32, minibatch_size=32, update_epochs=2,
              target_kl=target_kl, pool_size=2)
    jcfg = JPPOConfig(**kw)
    lr, ent_coef = 1e-3, 0.02
    mesh = jmesh.make_mesh(dp=2, tp=1)
    jts = jppo.init_train_state(jcfg).replace(params=jax_params(flat))
    jts = jts.replace(opt_state=jppo.make_optimizer(jcfg).init(jts.params))
    _, sub = jax.random.split(jts.key)
    perms = [np.asarray(jax.random.permutation(k, T * N))
             for k in jax.random.split(sub, jcfg.update_epochs)]
    jts = jmesh.shard_train_state(jts, mesh)
    jbatch = tuple(jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, JP("dp", *([None] * (x.ndim - 1))))) for x in batch)
    jts2, jmetrics = jax.jit(lambda ts, b: jppo._ppo_epochs(
        jcfg, ts, b, jnp.float32(lr), jnp.float32(ent_coef)))(jts, jbatch)

    pbatch = tuple(x.astype(np.int64) if i == 2 else x for i, x in enumerate(batch))
    outs = fleets(2).call(ranks.epochs, kw, flat, pbatch, perms, lr, ent_coef)
    adam = adam_state_of(jts2.opt_state)
    for out in outs:
        assert out["count"] == int(adam.count)
        assert_params_close(out["params"], jax_leaves_as_torch_order(jts2.params), 1e-4, 1e-6)
        assert_params_close(out["mu"], jax_leaves_as_torch_order(adam.mu), 1e-4, 1e-6)
        for k in jmetrics:
            np.testing.assert_allclose(out["metrics"][k], float(jmetrics[k]), atol=1e-5, rtol=1e-5)
    assert int(adam.count) == (2 if target_kl else 8)


@pytest.mark.parametrize("hidden", [128, 256, 768])
def test_param_spec_matches_jax(hidden):
    """The port's tp classification by shape equals the JAX package's on
    every param shape (JAX layout) of the actor-critic at this width."""
    shapes = []
    for out in (45, 1):
        shapes += [(297, hidden), (hidden,), (hidden, hidden), (hidden,), (hidden, out), (out,)]
    for shape in shapes:
        assert mesh_lib._param_spec(shape) == tuple(jmesh._param_spec(shape)), shape


@pytest.mark.parametrize("hidden", [64, 32])
def test_tp_update_shards_every_weight(hidden, fleets):
    """tp=2: every MLP weight holds half its hidden dim on each rank, and
    the update equals one process's at JAX's tolerances."""
    kw = dict(TINY, num_envs=8, hidden=hidden)
    ts, m = single_update(kw)
    outs = fleets(2).call(ranks.update, kw, 1, 2)
    whole = [tuple(p.shape) for p in ts.params.parameters()]
    for got, want in zip(outs[0]["shapes"], whole):
        if len(want) == 2:  # every weight: its hidden dim split in two
            assert got != want and np.prod(got) * 2 == np.prod(want), (got, want)
    assert_params_close(outs[0]["params"], [p.detach().numpy() for p in ts.params.parameters()])
    assert np.isfinite(outs[0]["metrics"]["loss"])
    spec = mesh_lib.train_state_shardings(ts, mesh_lib.Mesh(dp=1, tp=2))
    assert all("tp" in spec["params"][f"{h}.{i}.w"] for h in ("actor", "critic") for i in range(3))


def test_tp_gather_prepares_current_once_a_rollout(fleets):
    """The tp gather's writer: `set_current` from tp-sharded params writes
    whole gathered weights into CURRENT, whose handle then prepares once
    for all the rollout's forwards, the plain preparation of the whole
    weights on each rank; the frozen slots keep their preparations."""
    for out in fleets(2).call(ranks.tp_handles, TINY):
        assert out["sharded"] and all(out["ok"]), out
        assert out["preparations"] == [1, 1, 3], out


def test_tp_forward_and_gradients_equal_the_whole_model(fleets):
    """The Megatron forward on two ranks' shards (reduce-scatter between
    the hidden layers, all-reduce of the heads) gives the whole model's
    logits, loss and every gradient, gathered."""
    rng = np.random.RandomState(2)
    flat = numpy_params(rng, 32)
    obs, mask, action, logp, value, adv, ret = numpy_batch(rng, flat, 24)
    batch = {"mask": mask, "action": action.astype(np.int64), "logp": logp, "value": value,
             "adv": adv, "ret": ret}
    for out in fleets(2).call(ranks.tp_grads, flat, obs, batch):
        np.testing.assert_allclose(out["logits"], out["want_logits"], rtol=1e-5, atol=1e-6)
        assert out["loss"] == pytest.approx(out["want_loss"], rel=1e-5)
        assert_params_close(out["grads"], out["want_grads"], 1e-4, 1e-6)


def test_train_cli_mesh_flags(tmp_path, fleets):
    """--dp 2 --tp 2 through `train.train` on 4 ranks: the mesh the flags ask
    for (dp=-1 fills dp from the world size), every update taken, the
    weights sharded, and one writer."""
    argv = ["--dp", "2", "--tp", "2", "--total-timesteps", "128", "--num-envs", "8",
            "--num-steps", "4", "--minibatch-size", "16", "--pool-size", "2", "--hidden", "32",
            "--eval-every-updates", "1000", "--checkpoint-every-updates", "1000",
            "--log-dir", str(tmp_path)]
    outs = fleets(4).call(ranks.train_cli, argv)
    for out in outs:
        assert out["dp_tp"] == (2, 2) and out["mesh"] == {"dp": 2, "tp": 2}
        assert out["auto"] == {"dp": 2, "tp": 2}
        assert out["update_idx"] == out["num_updates"] == 4
        assert out["w0"] == (16, 297)  # the actor's first layer: 32 hidden columns over 2
    assert all(np.array_equal(a, b) for a, b in zip(outs[0]["params"], outs[3]["params"]))
    assert json.loads((tmp_path / "config.json").read_text())["dp"] == 2
    assert (tmp_path / "ppo_splendor_latest.pt").is_file()
    assert (tmp_path / "ppo_splendor_params.npz").is_file()
    assert len(list((tmp_path / "checkpoints").iterdir())) == 1


def test_resume_mesh_roundtrip(tmp_path, fleets):
    """dp=2 x tp=2: 2 updates, a checkpoint of the sharded state, a restore
    into a fresh sharded state and 1 more update are bit-identical to 3
    uninterrupted updates (params, both moments, games, generator)."""
    kw = dict(TINY, num_envs=8, total_timesteps=8 * 4 * 3)
    outs = fleets(4).call(ranks.resume, kw, 2, 2, str(tmp_path))
    for out in outs:
        assert out["update_idx"] == 3 and out["w0"] == (16, 297)
        assert out["obs_equal"] and out["gen_equal"]
        for a, c in zip(out["a"], out["c"]):
            np.testing.assert_array_equal(a, c)
    saved = torch.load(tmp_path / "ppo_splendor_latest.pt", weights_only=True)
    assert saved["obs"].shape == (8, 297)  # the whole batch, gathered over dp
    assert saved["params"]["actor.0.weight"].shape == (32, 297)  # whole, gathered over tp


def test_two_process_default_config_gets_a_global_mesh(tmp_path, fleets):
    """Two processes through `init_multihost` with explicit arguments: the
    default config (dp=0) gets a dp=2 mesh, both compute the same loss and
    params as one process, and only the coordinator writes."""
    ts, m = single_update(TINY)
    outs = fleets(2).call(ranks.default_mesh, TINY, str(tmp_path))
    assert [o["mesh"] for o in outs] == [{"dp": 2, "tp": 1}] * 2
    assert outs[0]["loss"] == outs[1]["loss"] == pytest.approx(m["loss"].item(), rel=1e-4)
    assert [(o["writer"], o["coordinator"]) for o in outs] == [(True, True), (False, False)]
    assert all(o["saved"] for o in outs)
    assert len(list((tmp_path / "checkpoints").iterdir())) == 1
    assert_params_close(outs[1]["params"], [p.detach().numpy() for p in ts.params.parameters()])


@pytest.mark.parametrize("device,cards,world,local_arg,env,want", [
    ("cuda", 4, 8, None, None, "nccl"),  # 2 hosts x 4 cards from explicit arguments
    ("cuda", 1, 2, 2, None, "gloo"),     # `spawn`: 2 ranks share one card
    ("cuda", 1, 2, None, "2", "gloo"),   # torchrun's LOCAL_WORLD_SIZE on one card
    ("cpu", 4, 2, None, None, "gloo"),
])
def test_choose_backend_local_world(device, cards, world, local_arg, env, want, monkeypatch):
    """NCCL exactly when each rank of this host has a card of its own; ranks
    started from explicit arguments count at most one per card of the host,
    not the global world."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    if env is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", env)
    assert multihost.choose_backend(device, multihost.local_world(world, local_arg)) == want


def test_dryrun_multichip():
    """`dryrun_multichip(4)`: the plain update, the static league slot and
    the Gumbel-search eval on dp=2 x tp=2."""
    results = dryrun.dryrun_multichip(4, device="cpu")
    lines = results[0]["lines"]
    assert lines[0].startswith("dryrun_multichip OK: mesh dp=2 tp=2")
    assert "league OK" in lines[1] and "all actions legal" in lines[2]
    assert all(r["device"] == "cpu" for r in results)
    assert results[0]["routes"]["reduce_scatter all_reduce"] > 0


def test_bench_scaling_tiny(capsys):
    """The scaling bench at tiny shapes on the CPU: one JSON line per world
    size and a summary that says the ranks share the host."""
    lines = bench_scaling.main(["--ranks", "2", "--batch-per-rank", "8", "--steps", "2",
                                "--reps", "1", "--device", "cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed == lines and [x.get("ranks") for x in lines] == [1, 2, 2]
    assert all(x["steps_per_sec"] > 0 for x in lines[:2])
    assert lines[-1]["metric"] == "weak_scaling_efficiency" and "not scaling" in lines[-1]["note"]


@pytest.mark.parametrize("censored", [False, True])
def test_gumbel_draw_inputs_are_the_search_draws(censored):
    """`gumbel.draw_inputs` takes the generator's values in the order the
    search takes them: the search on them equals the search drawing for
    itself, and `draw_rows` of a game block equals that block's search."""
    from splendax_torch.models import actor_critic as ac

    g = torch.Generator().manual_seed(4)
    state, obs, mask = core.reset(6, g, "cpu")
    w = ac.kernel_weights(ac.ActorCritic(32, g, "cpu"))
    m, k0, h = 4, 2, 2
    fn = gumbel.gumbel_search_fn(m=m, k0=k0, horizon=h, greedy_final=True,
                                 determinize_fn=determinize if censored else None)
    own = fn(w, obs, mask, state, torch.Generator().manual_seed(9))
    draws = gumbel.draw_inputs(6, m, k0, h, torch.Generator().manual_seed(9), "cpu",
                               censored=censored)
    assert torch.equal(fn(w, obs, mask, state, None, draws=draws), own)
    part = fn(w, obs[2:5], mask[2:5], state.map(lambda x: x[2:5]), None,
              draws=gumbel.draw_rows(draws, 2, 5, m, k0))
    assert torch.equal(part, own[2:5])

"""The port's learner (`splendax_torch.train.ppo`, `train.optim`) against the
JAX package on identical inputs made from a numpy seed: log-prob and
entropy, GAE, the schedules, the clipped loss with every gradient, the
optimizer against optax, the epochs on JAX's own permutations with and
without the KL stop, and whole `update_step`s on the CPU."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.models import actor_critic as jac
from splendax.train import ppo as jppo
from splendax.train.config import PPOConfig as JPPOConfig
from splendax_torch.models import actor_critic as ac
from splendax_torch.selfplay import pool as pool_lib
from splendax_torch.train import optim, ppo
from splendax_torch.train.config import PPOConfig

H = 32


def numpy_params(rng, hidden):
    out = {}
    for head, n_out in (("actor", 45), ("critic", 1)):
        for i, (fi, fo) in enumerate(((297, hidden), (hidden, hidden), (hidden, n_out))):
            bound = 1.0 / np.sqrt(fi)
            out[f"{head}.{i}.w"] = rng.uniform(-bound, bound, (fi, fo)).astype(np.float32)
            out[f"{head}.{i}.b"] = rng.uniform(-bound, bound, (fo,)).astype(np.float32)
    return out


def jax_params(flat):
    return {h: [{"w": jnp.asarray(flat[f"{h}.{i}.w"]), "b": jnp.asarray(flat[f"{h}.{i}.b"])}
                for i in range(3)] for h in ("actor", "critic")}


def jax_leaves_as_torch_order(tree):
    """The leaves of a JAX param-shaped tree in the order and layout of
    `ActorCritic.parameters()`: per layer the weight as [out, in], then the
    bias, actor before critic."""
    return [np.asarray(x) for h in ("actor", "critic") for layer in tree[h]
            for x in (np.asarray(layer["w"]).T, layer["b"])]


def numpy_batch(rng, flat, B, logp_shift=0.0, logp_noise=0.3):
    """A PPO minibatch from numpy: engine-like obs (small ints), 40% legal
    masks with row 0 holding no legal action, legal actions, an old logp
    `logp_noise` around the params' own (so clipped and unclipped ratios
    both occur), old values, advantages and returns."""
    obs = rng.randint(0, 8, size=(B, 297)).astype(np.int32)
    mask = rng.rand(B, 45) < 0.4
    mask[0] = False
    mask[1:, 0] |= ~mask[1:].any(1)
    action = np.where(mask.any(1), (rng.rand(B, 45) * mask).argmax(1), 3).astype(np.int32)
    logits = jac.actor_logits(jax_params(flat), jnp.asarray(obs))
    true_logp, _ = jac.log_prob_entropy(logits, jnp.asarray(mask), jnp.asarray(action))
    logp = (np.asarray(true_logp) + logp_shift + logp_noise * rng.randn(B)).astype(np.float32)
    value = rng.randn(B).astype(np.float32) * 0.3
    adv = rng.randn(B).astype(np.float32)
    ret = (value + 0.5 * rng.randn(B)).astype(np.float32)
    return obs, mask, action, logp, value, adv, ret


def to_torch(batch):
    return tuple(torch.from_numpy(x.astype(np.int64) if i == 2 else x)
                 for i, x in enumerate(batch))


def test_log_prob_entropy_matches_jax():
    """atol 1e-6: log-prob and entropy of the masked categorical, with a row
    that has no legal action."""
    rng = np.random.RandomState(0)
    logits = rng.randn(64, 45).astype(np.float32) * 3
    mask = rng.rand(64, 45) < 0.3
    mask[0] = False
    action = rng.randint(0, 45, 64)
    jl, je = jac.log_prob_entropy(jnp.asarray(logits), jnp.asarray(mask), jnp.asarray(action))
    pl, pe = ac.log_prob_entropy(torch.from_numpy(logits), torch.from_numpy(mask),
                                 torch.from_numpy(action))
    legal = mask[np.arange(64), action] | ~mask.any(1)
    np.testing.assert_allclose(pl.numpy()[legal], np.asarray(jl)[legal], atol=1e-6, rtol=1e-6)
    # An illegal action's log-prob is about -1e9 in both: compare relatively.
    np.testing.assert_allclose(pl.numpy()[~legal], np.asarray(jl)[~legal], rtol=1e-6)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), atol=1e-6, rtol=1e-6)


def test_critic_value_matches_forward():
    model = ac.params_from_jax(numpy_params(np.random.RandomState(1), H), device="cpu")
    obs = torch.from_numpy(np.random.RandomState(2).randint(0, 8, (9, 297)).astype(np.int32))
    assert torch.equal(ac.critic_value(model, obs), model(obs)[1])


def test_gae_matches_jax():
    """atol 1e-6: GAE on a random trajectory with dones, T=16, N=24."""
    rng = np.random.RandomState(3)
    T, N = 16, 24
    reward = (rng.randn(T, N) * (rng.rand(T, N) < 0.2)).astype(np.float32)
    value = rng.randn(T, N).astype(np.float32)
    done = rng.rand(T, N) < 0.15
    last = rng.randn(N).astype(np.float32)
    jtraj = jppo.Rollout(obs=None, mask=None, action=None, logp=None, value=jnp.asarray(value),
                         reward=jnp.asarray(reward), done=jnp.asarray(done))
    jadv, jret = jppo._gae(JPPOConfig(), jtraj, jnp.asarray(last))
    ptraj = ppo.Rollout(obs=None, mask=None, action=None, logp=None,
                        value=torch.from_numpy(value), reward=torch.from_numpy(reward),
                        done=torch.from_numpy(done), overflow=None)
    padv, pret = ppo._gae(PPOConfig(), ptraj, torch.from_numpy(last))
    np.testing.assert_allclose(padv.numpy(), np.asarray(jadv), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(pret.numpy(), np.asarray(jret), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("lr_anneal", [False, True])
def test_anneal_matches_jax(lr_anneal):
    """atol 1e-9 (float32 arithmetic on both sides): learning rate and
    entropy coefficient over the first, a middle and the last update."""
    kw = dict(total_timesteps=16 * 128 * 37, lr_anneal=lr_anneal, lr=3e-4)
    for idx in (0, 1, 17, 36):
        jlr, jent = jppo._anneal(JPPOConfig(**kw), jnp.int32(idx))
        plr, pent = ppo._anneal(PPOConfig(**kw), idx)
        assert abs(plr - float(jlr)) < 1e-9 and abs(pent - float(jent)) < 1e-9, idx
    assert ppo._anneal(PPOConfig(total_timesteps=100), 0)[0] == pytest.approx(2.5e-4)


@pytest.mark.parametrize("quirk", [False, True])
def test_ppo_loss_and_gradients_match_jax(quirk):
    """rel 5e-4 (atol 1e-6 on gradients, 1e-6 on the values): the loss, its
    four parts and every gradient against `jax.value_and_grad` of the JAX
    `ppo_loss`, on identical params and batch; a row with no legal action;
    clipped and unclipped ratios both present."""
    rng = np.random.RandomState(4 + quirk)
    flat = numpy_params(rng, H)
    batch = numpy_batch(rng, flat, 96)
    kw = dict(reference_entropy_quirk=quirk)
    ent_coef = 0.02
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jppo.ppo_loss(JPPOConfig(**kw), ent_coef, p, *map(jnp.asarray, batch)),
        has_aux=True)(jax_params(flat))
    model = ac.params_from_jax(flat, device="cpu")
    loss, aux = ppo.ppo_loss(PPOConfig(**kw), ent_coef, model, *to_torch(batch))
    grads = torch.autograd.grad(loss, list(model.parameters()))

    tb = to_torch(batch)
    new_logp = ac.log_prob_entropy(model(tb[0])[0], tb[1], tb[2])[0]
    ratio = torch.exp(new_logp.detach() - tb[3])
    clipped = (ratio < 0.8) | (ratio > 1.2)
    assert clipped.any() and (~clipped).any()

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=5e-4, atol=1e-6)
    for got, want in zip(aux, jaux):
        np.testing.assert_allclose(got.item(), float(want), rtol=5e-4, atol=1e-6)
    for got, want in zip(grads, jax_leaves_as_torch_order(jgrads)):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=1e-6)


def adam_state_of(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def test_optimizer_matches_optax():
    """atol 1e-6: 5 steps on fixed gradient sequences, global norms below
    and above the clip's 0.5, against optax's clip_by_global_norm(0.5) then
    adam(lr, eps=1e-5): params, mu, nu and count."""
    rng = np.random.RandomState(5)
    shapes = [(7, 5), (5,), (3, 7), (3,)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    scales = [0.01, 3.0, 0.05, 10.0, 0.2]
    grads = [[(rng.randn(*s) * sc).astype(np.float32) for s in shapes] for sc in scales]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs)) for gs in grads]
    assert min(norms) < 0.5 < max(norms)
    lr = 2.5e-4
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(lr, eps=1e-5))
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    pp = [torch.from_numpy(p.copy()) for p in p0]
    pstate = optim.init(pp)
    for gs in grads:
        updates, jstate = tx.update([jnp.asarray(g) for g in gs], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        pstate = optim.step(pp, [torch.from_numpy(g) for g in gs], pstate, lr)
        adam = adam_state_of(jstate)
        assert pstate.count == int(adam.count)
        for got, want in zip(pp + pstate.mu + pstate.nu, jp + list(adam.mu) + list(adam.nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_clip_has_no_epsilon_in_the_denominator():
    """A gradient of norm 5 comes out at norm 0.5 to float32 accuracy;
    dividing by norm + 1e-6 would leave it 1e-7 short, visible at 1e-8."""
    g = [torch.full((4,), 2.5, dtype=torch.float64)]
    out = optim.clip_by_global_norm(g)
    assert abs(out[0].norm().item() - 0.5) < 1e-12
    small = [torch.full((4,), 0.1)]
    assert torch.equal(optim.clip_by_global_norm(small)[0], small[0])


@pytest.mark.parametrize("target_kl,stops", [(1e9, False), (0.01, True)])
def test_ppo_epochs_match_jax_on_its_permutations(target_kl, stops):
    """One `_ppo_epochs` pass (2 epochs x 4 minibatches of 32) on an
    identical batch and JAX's own permutations.  Params rtol 1e-4 / atol
    1e-6, metrics 1e-5.  With target_kl=0.01 and an old logp 0.05 above the
    params' own, each epoch stops after its first minibatch: the Adam count
    ends at 2, not 8."""
    rng = np.random.RandomState(6)
    flat = numpy_params(rng, H)
    B = 128
    batch = numpy_batch(rng, flat, B, logp_shift=0.05, logp_noise=0.01)
    kw = dict(num_envs=16, num_steps=8, hidden=H, minibatch_size=32, update_epochs=2,
              target_kl=target_kl, pool_size=2)
    jcfg, pcfg = JPPOConfig(**kw), PPOConfig(**kw)
    lr, ent_coef = 1e-3, 0.02

    jts = jppo.init_train_state(jcfg).replace(params=jax_params(flat))
    jts = jts.replace(opt_state=jppo.make_optimizer(jcfg).init(jts.params))
    _, sub = jax.random.split(jts.key)
    perms = [np.asarray(jax.random.permutation(k, B))
             for k in jax.random.split(sub, jcfg.update_epochs)]
    jts2, jmetrics = jax.jit(lambda ts, b: jppo._ppo_epochs(
        jcfg, ts, b, jnp.float32(lr), jnp.float32(ent_coef)))(
        jts, tuple(map(jnp.asarray, batch)))

    model = ac.params_from_jax(flat, device="cpu")
    pts = ppo.init_train_state(pcfg, params=model, device="cpu")
    pts, pmetrics = ppo._ppo_epochs(pcfg, pts, to_torch(batch), lr, ent_coef,
                                    perms=[torch.from_numpy(p.copy()).long() for p in perms])

    adam = adam_state_of(jts2.opt_state)
    assert pts.opt_state.count == int(adam.count) == (2 if stops else 8)
    for got, want in zip(model.parameters(), jax_leaves_as_torch_order(jts2.params)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-6)
    for got, want in zip(pts.opt_state.mu, jax_leaves_as_torch_order(adam.mu)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    assert set(pmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(pmetrics[k].item(), float(jmetrics[k]), atol=1e-5, rtol=1e-5)


def test_ppo_epochs_draws_its_own_permutations():
    """Without `perms` the epochs draw from the state's generator: the same
    seed gives the same params, and every row is visited once an epoch."""
    rng = np.random.RandomState(7)
    flat = numpy_params(rng, H)
    batch = to_torch(numpy_batch(rng, flat, 96))
    cfg = PPOConfig(num_envs=8, num_steps=12, hidden=H, minibatch_size=40, update_epochs=1,
                    target_kl=0.0, pool_size=2)
    outs = []
    for _ in range(2):
        model = ac.params_from_jax(flat, device="cpu")
        ts = ppo.init_train_state(cfg, params=model, device="cpu")
        ts, _ = ppo._ppo_epochs(cfg, ts, batch, 1e-3, 0.02)
        assert ts.opt_state.count == 2  # 96 // 40 minibatches, the 16 left-over rows dropped
        outs.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def tiny_cfg(**kw):
    base = dict(num_envs=16, num_steps=8, hidden=H, pool_size=3, minibatch_size=32,
                update_epochs=2, total_timesteps=16 * 8 * 6, snapshot_every_updates=2,
                lr_anneal=True, seed=1)
    base.update(kw)
    return PPOConfig(**base)


def test_update_step_on_cpu():
    """Whole updates on the CPU: metric keys and finiteness, counters, the
    params move, a snapshot appears at update 2 (snapshot_every_updates=2)
    and stays frozen while update 3 trains."""
    cfg = tiny_cfg()
    ts = ppo.init_train_state(cfg, device="cpu")
    before = [p.detach().clone() for p in ts.params.parameters()]
    ts, m = ppo.update_step(cfg, ts)
    assert set(m) == {"pg_loss", "v_loss", "entropy", "approx_kl", "loss", "lr", "ent_coef",
                      "episodes", "rollout_win_rate", "mean_reward"}
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 and torch.isfinite(v) for v in m.values())
    assert ts.update_idx == 1 and ts.global_step == 128 and ts.pool.n_snapshots == 0
    assert ts.opt_state.count > 0
    assert any(not torch.equal(a, b) for a, b in zip(before, ts.params.parameters()))
    assert m["lr"].item() == pytest.approx(2.5e-4)
    ts, m = ppo.update_step(cfg, ts)
    assert m["lr"].item() == pytest.approx(2.5e-4 * (1 - 1 / 5))
    assert ts.pool.n_snapshots == 1
    snap = [w.clone() for w in ts.pool.slot(0)]
    for got, want in zip(snap, ac.kernel_weights(ts.params)):
        assert torch.equal(got, want)
    ts, _ = ppo.update_step(cfg, ts)
    assert ts.pool.n_snapshots == 1 and ts.update_idx == 3
    assert all(torch.equal(a, b) for a, b in zip(snap, ts.pool.slot(0)))
    assert any(not torch.equal(a, b) for a, b in zip(snap, ac.kernel_weights(ts.params)))
    # The CURRENT slot is re-read from the live params at the next rollout.
    cur = pool_lib.set_current(ts.pool, ts.params).slot(cfg.pool_size)
    assert all(torch.equal(a, b) for a, b in zip(cur, ac.kernel_weights(ts.params)))


@pytest.mark.parametrize("opponent", ["random", "greedy_v1", "basic"])
def test_update_step_against_a_heuristic(opponent):
    """self_play=False: the heuristic plays every game, no snapshot is
    pushed and no per-slot stats are kept, even in pfsp mode."""
    cfg = tiny_cfg(self_play=False, train_opponent=opponent, snapshot_every_updates=1,
                   opponent_sampling="pfsp")
    ts = ppo.init_train_state(cfg, device="cpu")
    ts, m = ppo.update_step(cfg, ts)
    assert torch.isfinite(m["loss"]) and ts.pool.n_snapshots == 0
    assert ts.pool.games.sum() == 0 and ts.update_idx == 1


def test_update_step_pfsp_accumulates_stats():
    """A pfsp-mode update runs end to end and the pool stats account for
    every finished episode."""
    cfg = tiny_cfg(num_steps=48, opponent_sampling="pfsp", total_timesteps=16 * 48 * 6)
    ts = ppo.init_train_state(cfg, device="cpu")
    ts, m = ppo.update_step(cfg, ts)
    assert torch.isfinite(m["loss"])
    assert ts.pool.games.sum().item() == m["episodes"].item() > 0
    assert ts.pool.wins.sum() <= ts.pool.games.sum()


def test_advantages_are_normalised_with_the_population_std(monkeypatch):
    """The batch handed to the epochs has mean 0 and population standard
    deviation 1 within 1e-5; with torch.std's default (unbiased) it would
    be sqrt(127/128), 3.9e-3 off."""
    seen = {}

    def capture(cfg, ts, batch, lr, ent_coef_now, perms=None):
        seen["adv"] = batch[5]
        return ts, {k: torch.zeros(()) for k in ppo.METRIC_KEYS}

    monkeypatch.setattr(ppo, "_ppo_epochs", capture)
    cfg = tiny_cfg()
    ppo.update_step(cfg, ppo.init_train_state(cfg, device="cpu"))
    adv = seen["adv"]
    assert adv.shape == (128,)
    assert abs(adv.mean().item()) < 1e-5
    assert abs(adv.std(correction=0).item() - 1.0) < 1e-5
    assert abs(adv.std().item() - 1.0) > 1e-3


def test_train_state_fields_mirror_jax():
    names = {f.name for f in dataclasses.fields(ppo.TrainState)}
    jnames = set(jppo.TrainState.__dataclass_fields__)
    # JAX keeps the sharding in its arrays; the port's state names its mesh.
    assert names - {"generator", "mesh"} == jnames - {"key"}

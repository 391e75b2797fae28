"""The port's self-play rollout against the JAX package: one turn at a time
in lockstep, on the same params, pool, ring, Gumbel noise and opponent
resamples; plus the opponent pool and a whole `rollout()` on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.engine.types import GameState as JGameState
from splendax.env import ring as jring
from splendax.models import actor_critic as jac
from splendax.selfplay import dual as jdual
from splendax.selfplay import pool as jpool_lib
from splendax_torch.engine import rules, state as S
from splendax_torch.engine.encode import encode_observation
from splendax_torch.env import ring
from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.selfplay import pool as pool_lib
from splendax_torch.selfplay.opponents import uniform_legal_action
from splendax_torch.train import ppo
from splendax_torch.train.config import PPOConfig

H, P, B, T = 32, 3, 64, 120


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


def both_pools(rng):
    """The same pool in both packages: the agent in CURRENT and two frozen
    snapshots of their own."""
    agent, snaps = numpy_params(rng, H), [numpy_params(rng, H) for _ in range(2)]
    jp = jpool_lib.init_pool(jax_params(agent), P, 0.25)
    pp = pool_lib.init_pool(ac.params_from_jax(agent, device="cpu"), P, 0.25)
    for s in snaps:
        jp = jpool_lib.push_snapshot(jp, jax_params(s))
        pp = pool_lib.push_snapshot(pp, ac.params_from_jax(s, device="cpu"))
    jp = jpool_lib.set_current(jp, jax_params(agent))
    pp = pool_lib.set_current(pp, ac.params_from_jax(agent, device="cpu"))
    return agent, jp, pp


@jax.jit
def jax_turn(params, jpool, env_state, obs, mask, opp_idx, jr, noise, new_idx):
    """One turn composed from the JAX package's own functions, with the
    port's random inputs: argmax(masked logits + Gumbel) is
    `jax.random.categorical` with that noise."""
    logits, value = jac.forward(params, obs)
    ml = jac.masked_logits(logits, mask)
    action = jnp.argmax(ml + noise, axis=-1).astype(jnp.int32)
    logp = jnp.take_along_axis(jax.nn.log_softmax(ml), action[:, None], 1)[:, 0]
    policy = jpool_lib.pool_greedy_policy(jpool, opp_idx)
    env_state, out, obs, mask, done, jr = jdual.dual_step_autoreset_ring(
        env_state, action, policy, jax.random.PRNGKey(0), jr, "fast")
    opp_idx = jnp.where(done, new_idx, opp_idx)
    return (env_state, obs, mask, opp_idx, jr,
            dict(logits=ml, value=value, action=action, logp=logp,
                 opp_action=out.opp_action, reward=out.agent_reward, done=done))


def test_rollout_turns_match_jax_in_lockstep():
    """H=32, pool of 3, 64 games, 120 turns, fast mode.  Exact: actions,
    opponent actions, all state fields, obs, masks, rewards, done and the
    ring's ptr and overflow.  rtol/atol 1e-5 (f32 sums in another order):
    logits, values and log-probs."""
    rng = np.random.RandomState(7)
    agent, jp, pp = both_pools(rng)
    cfg = PPOConfig(num_envs=B, num_steps=T, hidden=H, pool_size=P)
    weights = pp.slot(P)

    st = S.initial_state(B, torch.Generator().manual_seed(7), device="cpu")
    obs, mask = encode_observation(st), rules.legal_mask(st)
    js = JGameState(**{k: jnp.asarray(v) for k, v in S.to_numpy(st).items()})
    jobs, jmask = jnp.asarray(obs.numpy()), jnp.asarray(mask.numpy())
    jr = jring.make_ring(jax.random.PRNGKey(7), 2 * B, window=B)
    pr = ring.FreshGameRing(
        packed=torch.from_numpy(np.array(jr.packed)), mask0=torch.from_numpy(np.array(jr.mask0)),
        ptr=torch.tensor(0), overflow=torch.tensor(0), size=2 * B,
    )
    opp_idx = rng.randint(0, P + 1, B)
    jidx, pidx = jnp.asarray(opp_idx, jnp.int32), torch.from_numpy(opp_idx).long()
    params = jax_params(agent)
    episodes = 0
    for t in range(T):
        noise = rng.gumbel(size=(B, 45)).astype(np.float32)
        new_idx = rng.randint(0, P + 1, B)
        js, jobs, jmask, jidx, jr, jrec = jax_turn(
            params, jp, js, jobs, jmask, jidx, jr, jnp.asarray(noise), jnp.asarray(new_idx, jnp.int32))
        turn = ppo.rollout_turn(cfg, weights, pp, st, obs, mask, pidx, pr,
                                noise=torch.from_numpy(noise), new_idx=torch.from_numpy(new_idx).long())
        st, obs, mask, pidx, pr = turn.env_state, turn.obs, turn.mask, turn.opp_idx, turn.ring
        msg = f"turn {t}"
        for k in ("action", "opp_action", "reward", "done"):
            np.testing.assert_array_equal(getattr(turn, k).numpy(), np.asarray(jrec[k]), err_msg=f"{msg} {k}")
        for k in ("logits", "value", "logp"):
            np.testing.assert_allclose(getattr(turn, k).numpy(), np.asarray(jrec[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{msg} {k}")
        ps = S.to_numpy(st)
        for k in S.FIELDS:
            np.testing.assert_array_equal(ps[k], np.asarray(getattr(js, k)), err_msg=f"{msg} {k}")
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs), err_msg=f"{msg} obs")
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask), err_msg=f"{msg} mask")
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx), err_msg=f"{msg} opp_idx")
        assert int(pr.ptr) == int(jr.ptr) and int(pr.overflow) == int(jr.overflow), msg
        episodes += int(turn.done.sum())
    assert episodes > 50  # the ring was consumed, and wrapped (2B entries)


def test_rollout_on_cpu():
    """One whole `rollout()`: shapes, legal actions, logp equal to the
    log-softmax of the plain forward (rtol/atol 1e-5), no ring overflow."""
    cfg = PPOConfig(num_envs=32, num_steps=40, hidden=H, pool_size=P, seed=3)
    ts = ppo.init_train_state(cfg, device="cpu")
    ts, traj = ppo.rollout(cfg, ts)
    assert traj.obs.shape == (40, 32, 297) and traj.mask.shape == (40, 32, 45)
    for k in ("action", "logp", "value", "reward", "done"):
        assert getattr(traj, k).shape == (40, 32), k
    legal = traj.mask.gather(2, traj.action[..., None])[..., 0]
    assert bool((legal | ~traj.mask.any(-1)).all())
    w = ac.kernel_weights(ts.params)
    lp, v = fac.fused_masked_forward(w, traj.obs.reshape(-1, 297), traj.mask.reshape(-1, 45))
    want = torch.log_softmax(lp, -1).gather(1, traj.action.reshape(-1, 1))[:, 0]
    torch.testing.assert_close(traj.logp.reshape(-1), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(traj.value.reshape(-1), v, rtol=1e-5, atol=1e-5)
    assert int(traj.overflow) == 0
    assert int(traj.done.sum()) > 0
    assert ts.obs.shape == (32, 297) and ts.pool.games[P] == 0  # uniform mode keeps no counts


def test_unported_options_raise():
    """Every option is ported: dp and tp build the state on a mesh of their
    size, which one process cannot hold (the mesh's ValueError); heuristic
    opponents (self_play=False), the league slot (search_opponent),
    rng_mode="parity" and the full-batch autoreset (reset_ring_mult=0)
    build a state; an unknown rng_mode raises."""
    for kw in (dict(dp=2), dict(tp=2)):
        with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
            ppo.init_train_state(PPOConfig(num_envs=4, hidden=8, **kw), device="cpu")
    with pytest.raises(ValueError, match="rng_mode"):
        ppo.init_train_state(PPOConfig(num_envs=4, hidden=8, rng_mode="exact"), device="cpu")
    for kw in (dict(self_play=False), dict(search_opponent=True),
               dict(search_opponent=True, search_static=True, search_censored=True),
               dict(rng_mode="parity"), dict(reset_ring_mult=0)):
        ppo.init_train_state(PPOConfig(num_envs=4, hidden=8, **kw), device="cpu")


def test_pool_bookkeeping_matches_jax():
    """Exact: stacked slots after pushes past the pool size, the per-slot
    outcome counts and the PFSP win rates."""
    rng = np.random.RandomState(3)
    nets = [numpy_params(rng, 8) for _ in range(5)]
    jp = jpool_lib.init_pool(jax_params(nets[0]), P, 0.25)
    pp = pool_lib.init_pool(ac.params_from_jax(nets[0], device="cpu"), P, 0.25)
    for n in nets[1:]:
        jp = jpool_lib.push_snapshot(jp, jax_params(n))
        pp = pool_lib.push_snapshot(pp, ac.params_from_jax(n, device="cpu"))
    assert pp.n_snapshots == int(jp.n_snapshots) and pp.filled == int(jp.filled)
    jleaves = [l for h in ("actor", "critic") for i in range(3) for l in (jp.stack[h][i]["w"], jp.stack[h][i]["b"])]
    for got, want in zip(pp.stack, jleaves):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for _ in range(3):
        idx = rng.randint(0, P + 1, 200)
        done, won = rng.rand(200) < 0.5, rng.rand(200) < 0.5
        jp = jpool_lib.record_outcomes(jp, jnp.asarray(idx), jnp.asarray(done), jnp.asarray(won))
        pp = pool_lib.record_outcomes(pp, torch.from_numpy(idx), torch.from_numpy(done),
                                      torch.from_numpy(won))
    np.testing.assert_array_equal(pp.wins.numpy(), np.asarray(jp.wins))
    np.testing.assert_array_equal(pp.games.numpy(), np.asarray(jp.games))
    np.testing.assert_array_equal(pp.win_rates.numpy(), np.asarray(jp.win_rates))


@pytest.mark.parametrize("mode", ["uniform", "pfsp"])
def test_sample_opponent_idx_distribution(mode):
    """Slots lie in the filled part of the pool or CURRENT, CURRENT about
    p_current of the time, and every filled slot is drawn."""
    rng = np.random.RandomState(4)
    pp = pool_lib.init_pool(ac.params_from_jax(numpy_params(rng, 8), device="cpu"), 5, 0.25)
    g = torch.Generator().manual_seed(0)
    assert (pool_lib.sample_opponent_idx(pp, 100, g, mode) == 5).all()  # empty pool
    for _ in range(2):
        pp = pool_lib.push_snapshot(pp, ac.params_from_jax(numpy_params(rng, 8), device="cpu"))
    idx = pool_lib.sample_opponent_idx(pp, 20000, g, mode)
    assert set(idx.unique().tolist()) == {0, 1, 5}
    assert abs((idx == 5).float().mean().item() - 0.25) < 0.02


def test_uniform_legal_action_is_legal_and_uniform():
    rng = np.random.RandomState(5)
    mask = torch.from_numpy(rng.rand(4000, 45) < 0.3)
    mask[0] = False
    a = uniform_legal_action(mask, torch.Generator().manual_seed(1))
    assert a[0] == 0
    assert mask[1:].gather(1, a[1:, None]).all()
    row = torch.zeros(20000, 45, dtype=torch.bool)
    row[:, [3, 17, 44]] = True
    counts = torch.bincount(uniform_legal_action(row, torch.Generator().manual_seed(2)), minlength=45)
    assert counts[[3, 17, 44]].min() > 6000 and counts.sum() == 20000

"""The port's host APIs against the JAX package: the gym env, the
full-batch autoreset (`core.step_autoreset`, `dual.dual_step_autoreset`, the
`reset_ring_mult=0` rollout), the native C++ backend, the vector env, the
self-play wrappers and the host heuristics.  Exact throughout, except where
a net is involved (1e-5 on logits)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.engine.types import GameState as JGameState
from splendax.env import core as jcore
from splendax import native as jnative
from splendax.env.gym_compat import SplendorEnv as JSplendorEnv
from splendax.models import actor_critic as jac
from splendax.selfplay import dual as jdual
from splendax.selfplay import opponents as jopp
from splendax.selfplay import pool as jpool_lib
from splendax.selfplay import wrappers as jwrappers
from splendax_torch import native
from splendax_torch.engine import rules, state as S
from splendax_torch.engine.encode import encode_observation
from splendax_torch.env import core
from splendax_torch.env.gym_compat import SplendorEnv
from splendax_torch.env.vector import AutoresetMode, SplendaxVectorEnv
from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.selfplay import dual, opponents, wrappers
from splendax_torch.selfplay.opponents import uniform_legal_action
from splendax_torch.train import ppo
from splendax_torch.train.config import PPOConfig
from test_torch_rollout import H, P, both_pools, jax_params, numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF_TURN, OFF_MOVES, OFF_ROUND_OVER = 293, 295, 296


def to_jax(st):
    return JGameState(**{k: jnp.asarray(v) for k, v in S.to_numpy(st).items()})


def to_port(js):
    return S.from_numpy({k: np.array(getattr(js, k)) for k in S.FIELDS}, "cpu")


def fresh_of(jfresh):
    """JAX's fresh deals (state, obs, mask) as the port's `fresh=`."""
    return (to_port(jfresh[0]),) + tuple(torch.from_numpy(np.array(x)) for x in jfresh[1:])


def assert_states_equal(got, want, msg=""):
    ps = S.to_numpy(got)
    for k in S.FIELDS:
        np.testing.assert_array_equal(ps[k], np.asarray(getattr(want, k)), err_msg=f"{msg} {k}")


def assert_game_equal(got, want, msg=""):
    """Game 0 of the port's `got` against `want`: a port GameState with
    B=1, or one game of the JAX package's."""
    batched = isinstance(want, S.GameState)
    for k, v in S.to_numpy(got).items():
        w = getattr(want, k)
        np.testing.assert_array_equal(v[0], w[0].numpy() if batched else np.asarray(w),
                                      err_msg=f"{msg} {k}")


def sample_legal(rng, mask_rows):
    """A uniform legal action per row; 0 where none is legal."""
    acts = np.zeros(len(mask_rows), dtype=np.int32)
    for i, row in enumerate(mask_rows):
        legal = np.flatnonzero(row)
        if len(legal):
            acts[i] = rng.choice(legal)
    return acts


def midgame(B, plies, seed):
    """B games after `plies` uniform random legal plies on the port's
    engine (fast mode): (state, obs, mask)."""
    g = torch.Generator().manual_seed(seed)
    st, obs, mask = core.reset(B, g, "cpu")
    for _ in range(plies):
        st, out = core.step(st, uniform_legal_action(mask, g), mask=mask)
        obs, mask = out.obs, out.action_mask
    return st, obs, mask


@pytest.fixture(scope="module")
def jax_env():
    """One JAX env for the module: each instance jits its own step."""
    return JSplendorEnv(rng_mode="parity", backend="jax")


@pytest.fixture(scope="module")
def native_lib():
    """Builds the native library; a build failure fails the test."""
    return native._load()


# -- the single env ------------------------------------------------------------


def assert_same_step(got, want, msg, f32=False):
    """Equal step results.  `f32`: rewards compared as float32, for the
    native backend, which returns C++ doubles (-0.01, not float32's
    -0.009999999776)."""
    (o1, r1, t1, tr1, i1), (o2, r2, t2, tr2, i2) = got, want
    np.testing.assert_array_equal(o1, o2, err_msg=msg)
    assert o1.dtype == np.int32 and o1.dtype == o2.dtype, msg
    cast = np.float32 if f32 else float
    assert (cast(r1), t1, tr1) == (cast(r2), t2, tr2), msg
    assert type(r1) is float and type(t1) is bool, msg
    assert_same_info(i1, i2, msg, f32)


def assert_same_info(i1, i2, msg, f32=False):
    assert sorted(i1) == sorted(i2), msg
    for k, v in i2.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(i1[k], v, err_msg=f"{msg} {k}")
            assert i1[k].dtype == v.dtype, f"{msg} {k}"
        elif k == "final_rewards" and f32:
            assert {p: np.float32(r) for p, r in i1[k].items()} == {
                p: np.float32(r) for p, r in v.items()}, msg
        else:
            assert i1[k] == v and type(i1[k]) is type(v), f"{msg} {k}: {i1[k]} {v}"


def play_lockstep(env, jenv, seed, illegal_at=None, max_plies=400, f32=False):
    rng = np.random.RandomState(seed)
    o1, i1 = env.reset(seed=seed)
    o2, i2 = jenv.reset(seed=seed)
    np.testing.assert_array_equal(o1, o2)
    assert_same_info(i1, i2, "reset")
    for ply in range(max_plies):
        if ply == illegal_at:
            a = int(np.flatnonzero(i2["action_mask"] == 0)[0])
        else:
            legal = np.flatnonzero(i2["action_mask"])
            a = int(rng.choice(legal)) if len(legal) else 0
        got, want = env.step(a), jenv.step(a)
        assert_same_step(got, want, f"seed {seed} ply {ply}", f32)
        assert_game_equal(env.state, jenv.state, f"seed {seed} ply {ply}")
        if ply == illegal_at:
            assert got[4]["illegal_action"] and got[1] == pytest.approx(-0.01)
        i2 = want[4]
        if want[2]:
            return ply + 1
    raise AssertionError("the game did not end")


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 123, 999])
def test_single_env_matches_jax_ply_by_ply(jax_env, seed, capsys):
    """Parity mode on both: obs, reward, flags, every info entry and all 18
    state fields equal on every ply; one illegal action injected; then
    get_final_rewards, raise-after-terminal and the render() text."""
    env = SplendorEnv(backend="torch", device="cpu")
    assert env.backend == "torch" and env.observation_space.shape == (297,)
    play_lockstep(env, jax_env, seed, illegal_at=3 + seed % 5)
    assert env.get_final_rewards() == jax_env.get_final_rewards()
    with pytest.raises(RuntimeError, match="termination"):
        env.step(0)
    capsys.readouterr()
    env.render()
    got = capsys.readouterr().out
    jax_env.render()
    assert got == capsys.readouterr().out and "GAME OVER" in got


def test_single_env_turn_limit_through_the_state_setter(jax_env):
    """The same state set on both envs one ply before the turn limit: the
    draw at -0.1 each, `turn_limit` in the info, and get_final_rewards."""
    env = SplendorEnv(backend="torch", device="cpu")
    for e in (env, jax_env):
        e.reset(seed=5)
    with pytest.raises(RuntimeError, match="non-terminal"):
        env.get_final_rewards()
    st = env.state.replace(move_count=torch.tensor([197], dtype=torch.int32),
                           turn_count=torch.tensor([99], dtype=torch.int32),
                           to_play=torch.tensor([1], dtype=torch.int32))
    env.state = st
    jax_env.state = JGameState(**{k: jnp.asarray(v[0]) for k, v in S.to_numpy(st).items()})
    a = int(rules.legal_mask(st)[0].nonzero()[0, 0])
    got, want = env.step(a), jax_env.step(a)
    assert_same_step(got, want, "turn limit")
    assert got[2] and got[4]["turn_limit"] and got[1] == pytest.approx(-0.1)
    assert env.get_final_rewards() == jax_env.get_final_rewards()
    assert_game_equal(env.state, jax_env.state)


def test_single_env_spaces_and_gym_registration():
    """The spaces and the Box(0, 50) quirk; "SplendaxTorch-v0" makes the
    port's env while "Splendax-v0" still makes the JAX package's."""
    import gymnasium as gym

    env = gym.make("SplendaxTorch-v0", device="cpu", backend="torch")
    assert isinstance(env.unwrapped, SplendorEnv)
    assert env.action_space.n == 45 and float(env.observation_space.high[295]) == 50.0
    obs, info = env.reset(seed=0)
    assert obs.shape == (297,) and info["action_mask"].dtype == np.int8
    assert isinstance(gym.make("Splendax-v0").unwrapped, JSplendorEnv)
    from gymnasium.utils.env_checker import check_env

    check_env(SplendorEnv(backend="torch", device="cpu"), skip_render_check=True)


def test_envs_default_to_the_gpu():
    """Both envs run on the card unless told otherwise; without one they
    raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: SplendorEnv(backend="torch"), lambda: SplendorEnv(),
                 lambda: SplendaxVectorEnv(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(ValueError, match="backend"):
        SplendorEnv(backend="jax", device="cpu")
    with pytest.raises(ValueError, match="parity"):
        SplendorEnv(backend="native", rng_mode="fast", device="cpu")


def test_auto_backend_follows_the_jax_rule(native_lib):
    """"auto" is native in parity mode when the library builds, else torch."""
    assert SplendorEnv(device="cpu").backend == "native"
    assert SplendorEnv(device="cpu", rng_mode="fast").backend == "torch"


def test_native_backend_equals_torch_backend_over_whole_games(native_lib):
    """The two backends of the port's env, bit for bit through the gym API,
    with an illegal action injected; the native state setter raises."""
    for seed in (77, 78):
        a_env = SplendorEnv(backend="torch", device="cpu")
        b_env = SplendorEnv(backend="native", device="cpu")
        play_lockstep(a_env, b_env, seed, illegal_at=2, f32=True)
        assert ({p: np.float32(r) for p, r in a_env.get_final_rewards().items()}
                == {p: np.float32(r) for p, r in b_env.get_final_rewards().items()})
    with pytest.raises(AttributeError):
        b_env.state = a_env.state


# -- the full-batch autoreset -------------------------------------------------


@jax.jit
def jax_step_autoreset(state, action, key):
    return jcore.step_autoreset(state, action, key), jcore.reset_batch(
        jax.random.split(key, action.shape[0]))


def test_step_autoreset_matches_jax_on_its_fresh_deals():
    """`core.step_autoreset` fed JAX's fresh deals: carry, out, obs_next and
    mask_next exact for 50 plies of 32 games from mid-game, with games
    ending."""
    B = 32
    st, obs, mask = midgame(B, 70, 3)
    js = to_jax(st)
    rng = np.random.RandomState(3)
    ended = 0
    for t in range(50):
        a = sample_legal(rng, mask.numpy())
        (js, jout, jobs, jmask), jfresh = jax_step_autoreset(js, jnp.asarray(a),
                                                              jax.random.PRNGKey(t))
        fresh = fresh_of(jfresh)
        st, out, obs, mask = core.step_autoreset(st, torch.from_numpy(a).long(), fresh=fresh)
        msg = f"ply {t}"
        assert_states_equal(st, js, msg)
        for k in ("obs", "reward", "terminated", "action_mask", "to_play", "illegal_action",
                  "draw", "turn_limit", "final_rewards"):
            np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(jout, k)),
                                          err_msg=f"{msg} {k}")
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs), err_msg=msg)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask), err_msg=msg)
        ended += int(out.terminated.sum())
    assert ended >= 8


@jax.jit
def jax_dual_autoreset(state, action, key):
    def opp(o, m, s, k):
        return jax.vmap(jopp.greedy_v1_policy)(o, m, s, jax.random.split(k, o.shape[0]))

    out = jdual.dual_step_autoreset(state, action, opp, key, "fast")
    _, k_reset = jax.random.split(key)
    return out, jcore.reset_batch(jax.random.split(k_reset, action.shape[0]))


def test_dual_step_autoreset_matches_jax_on_its_fresh_deals():
    """`dual.dual_step_autoreset` against greedy_v1, fed JAX's fresh deals:
    carry, every output, obs_next, mask_next and done exact for 30 turns
    of 32 games from mid-game."""
    B = 32
    st, obs, mask = midgame(B, 60, 4)
    js = to_jax(st)
    rng = np.random.RandomState(4)
    ended = 0
    for t in range(30):
        a = sample_legal(rng, mask.numpy())
        (js, jout, jobs, jmask, jdone), jfresh = jax_dual_autoreset(js, jnp.asarray(a),
                                                                     jax.random.PRNGKey(t))
        fresh = fresh_of(jfresh)
        st, out, obs, mask, done = dual.dual_step_autoreset(
            st, torch.from_numpy(a).long(), opponents.greedy_v1_policy, fresh=fresh)
        msg = f"turn {t}"
        assert_states_equal(st, js, msg)
        for k in ("agent_obs", "agent_reward", "opp_obs", "opp_reward", "done", "action_mask",
                  "opp_action", "ended_on_agent", "illegal_agent", "turn_limit"):
            np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(jout, k)),
                                          err_msg=f"{msg} {k}")
        for got, want in ((obs, jobs), (mask, jmask), (done, jdone)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)
        ended += int(done.sum())
    assert ended >= 8


def test_autoresets_deal_from_the_generator():
    """Without `fresh` both deal a full batch from the generator: valid
    fresh games where a game ended, the same generator state giving the
    same deals."""
    st, _, mask = midgame(16, 60, 5)
    a = uniform_legal_action(mask, torch.Generator().manual_seed(0))
    outs = [core.step_autoreset(st, a, torch.Generator().manual_seed(9)) for _ in range(2)]
    done = outs[0][1].terminated
    assert done.any()
    fresh = core.reset(16, torch.Generator().manual_seed(9), "cpu")[0]
    for k, v in outs[0][0].items():
        assert torch.equal(v, getattr(outs[1][0], k)), k
        assert torch.equal(v[done], getattr(fresh, k)[done]), k
    carry, out, obs, mask2, done2 = dual.dual_step_autoreset(
        st, a, opponents.greedy_v1_policy, torch.Generator().manual_seed(1))
    assert torch.equal(obs, encode_observation(carry)) and torch.equal(mask2, rules.legal_mask(carry))


@jax.jit
def jax_full_turn(params, jpool, env_state, obs, mask, opp_idx, key, noise, new_idx):
    """One turn of the JAX rollout's `reset_ring_mult=0` branch, with the
    port's action noise and opponent resample."""
    logits, value = jac.forward(params, obs)
    ml = jac.masked_logits(logits, mask)
    action = jnp.argmax(ml + noise, axis=-1).astype(jnp.int32)
    logp = jnp.take_along_axis(jax.nn.log_softmax(ml), action[:, None], 1)[:, 0]
    policy = jpool_lib.pool_greedy_policy(jpool, opp_idx)
    env_state, out, obs, mask, done = jdual.dual_step_autoreset(
        env_state, action, policy, key, "fast")
    opp_idx = jnp.where(done, new_idx, opp_idx)
    _, k_reset = jax.random.split(key)
    fresh = jcore.reset_batch(jax.random.split(k_reset, action.shape[0]))
    return (env_state, obs, mask, opp_idx, fresh,
            dict(logits=ml, value=value, action=action, logp=logp,
                 opp_action=out.opp_action, reward=out.agent_reward, done=done))


def test_full_batch_rollout_turns_match_jax_in_lockstep():
    """`rollout_turn` with no ring (reset_ring_mult=0), H=32, pool of 3, 64
    games from mid-game, 20 turns on JAX's fresh deals.  Exact: actions,
    opponent actions, states, obs, masks, rewards, done, opponent slots;
    rtol/atol 1e-5: logits, values, log-probs."""
    B, T = 32, 20
    rng = np.random.RandomState(8)
    agent, jp, pp = both_pools(rng)
    cfg = PPOConfig(num_envs=B, num_steps=T, hidden=H, pool_size=P, reset_ring_mult=0)
    weights = pp.slot(P)
    st, obs, mask = midgame(B, 60, 8)
    js, jobs, jmask = to_jax(st), jnp.asarray(obs.numpy()), jnp.asarray(mask.numpy())
    opp_idx = rng.randint(0, P + 1, B)
    jidx, pidx = jnp.asarray(opp_idx, jnp.int32), torch.from_numpy(opp_idx).long()
    params = jax_params(agent)
    episodes = 0
    for t in range(T):
        noise = rng.gumbel(size=(B, 45)).astype(np.float32)
        new_idx = rng.randint(0, P + 1, B)
        js, jobs, jmask, jidx, jfresh, jrec = jax_full_turn(
            params, jp, js, jobs, jmask, jidx, jax.random.PRNGKey(t), jnp.asarray(noise),
            jnp.asarray(new_idx, jnp.int32))
        fresh = fresh_of(jfresh)
        turn = ppo.rollout_turn(cfg, weights, pp, st, obs, mask, pidx, None,
                                noise=torch.from_numpy(noise),
                                new_idx=torch.from_numpy(new_idx).long(), fresh=fresh)
        st, obs, mask, pidx = turn.env_state, turn.obs, turn.mask, turn.opp_idx
        msg = f"turn {t}"
        assert turn.ring is None, msg
        for k in ("action", "opp_action", "reward", "done"):
            np.testing.assert_array_equal(getattr(turn, k).numpy(), np.asarray(jrec[k]),
                                          err_msg=f"{msg} {k}")
        for k in ("logits", "value", "logp"):
            np.testing.assert_allclose(getattr(turn, k).numpy(), np.asarray(jrec[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{msg} {k}")
        assert_states_equal(st, js, msg)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs), err_msg=f"{msg} obs")
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask), err_msg=f"{msg} mask")
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx), err_msg=f"{msg} opp_idx")
        episodes += int(turn.done.sum())
    assert episodes >= 5


def test_full_batch_update_step_on_cpu():
    """A whole `update_step` with reset_ring_mult=0: no ring, legal
    actions, logp equal to the plain forward's, finite metrics, the
    parameters move and the counters advance."""
    cfg = PPOConfig(num_envs=16, num_steps=24, hidden=16, pool_size=P, reset_ring_mult=0,
                    minibatch_size=128, update_epochs=1, seed=5)
    ts = ppo.init_train_state(cfg, device="cpu")
    before = [p.detach().clone() for p in ts.params.parameters()]
    _, traj = ppo.rollout(cfg, ts)
    legal = traj.mask.gather(2, traj.action[..., None])[..., 0]
    assert bool((legal | ~traj.mask.any(-1)).all()) and int(traj.overflow) == 0
    assert int(traj.done.sum()) > 0
    lp, _ = fac.fused_masked_forward(ac.kernel_weights(ts.params), traj.obs.reshape(-1, 297),
                                     traj.mask.reshape(-1, 45))
    want = torch.log_softmax(lp, -1).gather(1, traj.action.reshape(-1, 1))[:, 0]
    torch.testing.assert_close(traj.logp.reshape(-1), want, rtol=1e-5, atol=1e-5)
    ts, metrics = ppo.update_step(cfg, ts)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, ts.params.parameters()))
    assert ts.update_idx == 1 and ts.global_step == cfg.batch_size


# -- the native backend ---------------------------------------------------------


def test_native_initial_state_matches_parity_deal(native_lib):
    for seed in (0, 1, 42, 12345):
        got, want = native.NativeGame(seed).to_game_state("cpu"), S.initial_state_parity(seed, "cpu")
        for k, v in want.items():
            assert torch.equal(getattr(got, k), v), (seed, k)


@pytest.mark.parametrize("seed", [7, 99])
def test_native_whole_game_matches_torch_parity_engine(native_lib, seed):
    """Random legal play: every ply the mask, obs, all 18 fields and the
    env_step reward and flags equal the port's engine in parity mode."""
    ng = native.NativeGame(seed)
    st = S.initial_state_parity(seed, "cpu")
    rng = np.random.RandomState(seed)
    for ply in range(400):
        mask = rules.legal_mask(st)
        np.testing.assert_array_equal(ng.legal_mask(), mask[0].numpy().astype(np.int8))
        np.testing.assert_array_equal(ng.observation(), encode_observation(st)[0].numpy())
        for k, v in ng.to_game_state("cpu").items():
            assert torch.equal(v, getattr(st, k)), (ply, k)
        legal = np.flatnonzero(mask[0].numpy())
        if ng.is_terminal():
            return
        a = int(rng.choice(legal)) if len(legal) else 0
        _, r, flags, _ = ng.env_step(a)
        st, out = core.step(st, torch.tensor([a]), rng_mode="parity")
        assert r == float(out.reward[0]) and bool(flags & native.F_TERMINATED) == bool(out.terminated[0])
        assert bool(flags & native.F_DRAW) == bool(out.draw[0])
    raise AssertionError("the game did not end")


def test_native_env_step_contract_and_random_game(native_lib):
    ng = native.NativeGame(3)
    illegal = np.flatnonzero(ng.legal_mask() == 0)
    before = ng.state.copy()
    _, r, flags, _ = ng.env_step(int(illegal[0]))
    assert r == pytest.approx(-0.01) and flags & native.F_ILLEGAL
    np.testing.assert_array_equal(ng.state, before)  # a no-op
    plies, final = native.random_game(17)
    assert 10 < plies <= 400
    g = native.NativeGame(17)
    g.state[:] = final
    fr = g.final_rewards()
    assert g.is_terminal() and round(fr[0] + fr[1], 9) in (0.0, -0.2)


def test_native_to_game_state_round_trip(native_lib):
    """Every field of the flat state maps onto the GameState and back."""
    ng = native.NativeGame(5)
    rng = np.random.RandomState(0)
    for _ in range(30):
        ng.env_step(int(rng.choice(np.flatnonzero(ng.legal_mask()))))
    gs = ng.to_game_state("cpu")
    assert gs.batch_size == 1 and gs.game_over.dtype == torch.bool
    flat = np.zeros(native.STATE_SIZE, np.int32)
    for name, (off, shape) in native.STATE_LAYOUT.items():
        v = getattr(gs, name)[0].numpy().astype(np.int32).reshape(-1)
        flat[off: off + v.size] = v
        np.testing.assert_array_equal(np.asarray(ng.field(name)).reshape(-1), v, err_msg=name)
    np.testing.assert_array_equal(flat, ng.state)


def test_native_state_view_is_a_copy(native_lib):
    """`to_game_state` copies: stepping the game leaves an earlier view as
    it was (the logger keeps the state before each move)."""
    for seed in range(20):
        ng = native.NativeGame(seed)
        view = ng.to_game_state("cpu")
        before = {k: v.clone() for k, v in view.items()}
        ng.env_step(int(np.flatnonzero(ng.legal_mask())[0]))
        assert all(torch.equal(v, before[k]) for k, v in view.items())
        assert int(ng.field("move_count")) == 1


def test_native_batch_equals_single_games(native_lib):
    """NativeBatch's one call equals N NativeGames stepped one by one,
    lane resets and illegal actions included."""
    n = 6
    nb = native.NativeBatch(n)
    seeds = np.arange(100, 100 + n)
    obs, mask = nb.reset(seeds)
    games = [native.NativeGame(int(s)) for s in seeds]
    rng = np.random.RandomState(1)
    for t in range(250):
        acts = sample_legal(rng, mask)
        if t % 17 == 0:
            acts[0] = int(np.flatnonzero(mask[0] == 0)[0]) if (mask[0] == 0).any() else acts[0]
        reset_lane = np.zeros(n, np.int8)
        reset_seeds = np.zeros(n, np.int64)
        for i, g in enumerate(games):
            if g.is_terminal():
                reset_lane[i], reset_seeds[i] = 1, 1000 * t + i
                games[i] = native.NativeGame(int(reset_seeds[i]))
        obs, mask, reward, flags, final = nb.step(acts, reset_lane, reset_seeds)
        for i, g in enumerate(games):
            if reset_lane[i]:
                np.testing.assert_array_equal(obs[i], g.observation())
                assert flags[i] == 0 and reward[i] == 0.0
                continue
            o, r, f, m = g.env_step(int(acts[i]))
            np.testing.assert_array_equal(obs[i], o)
            np.testing.assert_array_equal(mask[i], m)
            assert (reward[i], flags[i]) == (r, f)
            np.testing.assert_array_equal(nb.states[i], g.state)
    np.testing.assert_array_equal(nb.to_play(), [g.field("to_play") for g in games])


def test_native_concurrent_builds_into_one_fresh_directory(tmp_path):
    """Four processes build the library into one empty directory at once;
    all four load it."""
    env = dict(os.environ, SPLENDAX_TORCH_NATIVE_DIR=str(tmp_path), PYTHONPATH=REPO)
    code = "import splendax_torch.native as n; n._load(); print('loaded')"
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", err
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(libs) == 1 and not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


# -- the vector env -------------------------------------------------------------

BACKENDS = ["torch", "native"]


def venv(n, backend, **kw):
    if backend == "native":
        native._load()
    return SplendaxVectorEnv(num_envs=n, backend=backend, device="cpu", **kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_spaces_and_reset(backend):
    N = 8
    envs = venv(N, backend)
    assert envs.single_action_space.n == 45 and envs.single_observation_space.shape == (297,)
    assert envs.action_space.shape == (N,) and envs.observation_space.shape == (N, 297)
    assert float(envs.single_observation_space.high[295]) == 200.0
    obs, infos = envs.reset(seed=0)
    assert obs.shape == (N, 297) and obs.dtype == np.int32
    assert infos["action_mask"].shape == (N, 45) and infos["action_mask"].dtype == np.int8
    assert infos["action_mask"].any(axis=1).all() and infos["_action_mask"].all()
    assert (infos["to_play"] == 0).all()
    assert (obs[:, OFF_MOVES] == 0).all() and (obs[:, OFF_TURN] == 1).all()
    assert not (obs[0] == obs[1]).all()
    with pytest.raises(RuntimeError):
        venv(2, backend).step(np.zeros(2, dtype=np.int32))
    with pytest.raises(ValueError):
        envs.step(np.array([45] + [0] * (N - 1)))
    with pytest.raises(ValueError):
        envs.step(np.array([0] * (N - 1) + [-1]))
    with pytest.raises(ValueError):
        venv(2, backend, autoreset_mode=AutoresetMode.DISABLED)
    envs.close()
    assert envs.closed and envs._states is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_next_step_autoreset_rollout(backend):
    """NEXT_STEP: observations stay in the declared space, lanes that ended
    last step return a fresh game with reward 0, ended lanes show a zero
    mask and final rewards, every played action is legal."""
    N = 8
    envs = venv(N, backend, autoreset_mode=AutoresetMode.NEXT_STEP)
    obs, infos = envs.reset(seed=1)
    rng = np.random.RandomState(0)
    pending = np.zeros(N, dtype=bool)
    episodes = 0
    for _ in range(220):
        assert envs.observation_space.contains(obs)
        acts = sample_legal(rng, infos["action_mask"])
        obs, reward, term, trunc, infos = envs.step(acts)
        assert not trunc.any()
        if "illegal_action" in infos:
            assert not infos["illegal_action"][~pending].any()
        if pending.any():
            assert (reward[pending] == 0).all() and not term[pending].any()
            assert (obs[pending, OFF_MOVES] == 0).all()
        if term.any():
            episodes += int(term.sum())
            assert not infos["action_mask"][term].any()
            fr = infos["final_rewards"][term]
            assert np.isin(fr, np.float32([-1.0, -0.1, 0.0, 1.0])).all()
        pending = term.copy()
    assert episodes > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_same_step_autoreset_final_obs(backend):
    N = 8
    envs = venv(N, backend, autoreset_mode=AutoresetMode.SAME_STEP)
    obs, infos = envs.reset(seed=2)
    rng = np.random.RandomState(1)
    saw_terminal = False
    for _ in range(220):
        acts = sample_legal(rng, infos["action_mask"])
        obs, reward, term, trunc, infos = envs.step(acts)
        if term.any():
            saw_terminal = True
            assert (obs[term, OFF_MOVES] == 0).all() and infos["_final_obs"][term].all()
            assert (infos["final_obs"][~term] == None).all()  # noqa: E711
            for i in np.nonzero(term)[0]:
                fo = infos["final_obs"][i]
                assert fo is not None and fo.shape == (297,)
                assert fo[OFF_MOVES] > 0 or fo[OFF_ROUND_OVER] == 1
            assert infos["action_mask"][term].any(axis=1).all()
        else:
            assert "final_obs" not in infos
    assert saw_terminal


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_seeding(backend):
    """The same seed gives the same run; a seed list deals lane i from
    seeds[i]; a list of the wrong length raises."""
    a, b = venv(4, backend), venv(4, backend)
    obs_a, inf_a = a.reset(seed=7)
    obs_b, inf_b = b.reset(seed=7)
    assert (obs_a == obs_b).all()
    rng = np.random.RandomState(3)
    for _ in range(30):
        acts = sample_legal(rng, inf_a["action_mask"])
        obs_a, r_a, t_a, _, inf_a = a.step(acts)
        obs_b, r_b, t_b, _, inf_b = b.step(acts)
        assert (obs_a == obs_b).all() and (r_a == r_b).all() and (t_a == t_b).all()
        assert (inf_a["action_mask"] == inf_b["action_mask"]).all()
    envs = venv(3, backend)
    obs1, _ = envs.reset(seed=[5, 5, 9])
    assert (obs1[0] == obs1[1]).all() and not (obs1[0] == obs1[2]).all()
    with pytest.raises(ValueError):
        envs.reset(seed=[1, 2])


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_illegal_action_penalty(backend):
    envs = venv(2, backend)
    obs, infos = envs.reset(seed=11)
    illegal0 = int(np.flatnonzero(infos["action_mask"][0] == 0)[0])
    legal1 = int(np.flatnonzero(infos["action_mask"][1])[0])
    obs2, reward, term, _, infos2 = envs.step(np.array([illegal0, legal1]))
    assert reward[0] == pytest.approx(-0.01)
    assert infos2["illegal_action"][0] and not infos2["_illegal_action"][1]
    assert (obs2[0] == obs[0]).all() and obs2[1, OFF_MOVES] == 1


def test_torch_vector_seed_list_stream_depends_on_every_seed():
    """The autoreset stream of a seed list is seeded by a digest of all the
    seeds: lists that share seeds[0] deal different fresh games."""
    envs = [venv(2, "torch") for _ in range(2)]
    for e, seeds in zip(envs, ([3, 4], [3, 5])):
        e.reset(seed=seeds)
    draws = [torch.rand(4, generator=e._gen) for e in envs]
    assert not torch.equal(*draws)


@pytest.mark.parametrize("mode", [AutoresetMode.NEXT_STEP, AutoresetMode.SAME_STEP])
def test_native_vector_equals_sync_vector_env(native_lib, mode):
    """SplendaxVectorEnv(backend="native") against gym.vector.SyncVectorEnv
    over the port's native envs, bit for bit, in both autoreset modes."""
    import gymnasium as gym

    N, SEED, STEPS = 4, 123, 400
    ref = gym.vector.SyncVectorEnv(
        [lambda: SplendorEnv(rng_mode="parity", backend="native", device="cpu")
         for _ in range(N)], autoreset_mode=mode)
    ours = venv(N, "native", autoreset_mode=mode)
    obs_r, inf_r = ref.reset(seed=SEED)
    obs_o, inf_o = ours.reset(seed=SEED)
    np.testing.assert_array_equal(obs_o, obs_r)
    np.testing.assert_array_equal(inf_o["action_mask"], inf_r["action_mask"])
    rng = np.random.RandomState(5)
    n_term = 0
    for t in range(STEPS):
        acts = sample_legal(rng, inf_r["action_mask"])
        obs_r, r_r, term_r, _, inf_r = ref.step(acts)
        obs_o, r_o, term_o, _, inf_o = ours.step(acts)
        np.testing.assert_array_equal(obs_o, obs_r, err_msg=f"t={t}")
        np.testing.assert_array_equal(term_o, term_r, err_msg=f"t={t}")
        np.testing.assert_array_equal(r_o, r_r, err_msg=f"t={t}")
        np.testing.assert_array_equal(inf_o["action_mask"], inf_r["action_mask"], err_msg=f"t={t}")
        np.testing.assert_array_equal(inf_o["to_play"], inf_r["to_play"], err_msg=f"t={t}")
        if mode == AutoresetMode.SAME_STEP and term_o.any():
            for i in np.nonzero(term_o)[0]:
                np.testing.assert_array_equal(inf_o["final_obs"][i], inf_r["final_obs"][i])
        n_term += int(term_o.sum())
    assert n_term >= 4
    # An unseeded reset continues the per-lane streams, as sub-envs' do.
    obs_r, _ = ref.reset()
    obs_o, _ = ours.reset()
    np.testing.assert_array_equal(obs_o, obs_r)
    ref.close()


def test_sync_vector_env_over_the_torch_env():
    """The reference's own idiom, gym.vector.SyncVectorEnv over the
    port's env, keeps working."""
    import gymnasium as gym

    envs = gym.vector.SyncVectorEnv(
        [lambda: SplendorEnv(rng_mode="fast", backend="torch", device="cpu") for _ in range(3)])
    obs, infos = envs.reset(seed=11)
    assert obs.shape == (3, 297) and infos["action_mask"].shape == (3, 45)
    rng = np.random.RandomState(0)
    for _ in range(10):
        obs, r, term, trunc, infos = envs.step(sample_legal(rng, infos["action_mask"]))
        assert obs.shape == (3, 297)
    envs.close()


def test_envs_run_without_gymnasium():
    """With gymnasium hidden, both envs construct, reset and step on the
    stand-ins, in both autoreset modes and on both backends."""
    code = r"""
import sys
sys.modules["gymnasium"] = None
import numpy as np
from splendax_torch.env import _gym
from splendax_torch.env.gym_compat import SplendorEnv
from splendax_torch.env.vector import SplendaxVectorEnv
assert not _gym.HAVE_GYMNASIUM
for backend in ("torch", "native"):
    env = SplendorEnv(backend=backend, device="cpu")
    obs, info = env.reset(seed=3)
    assert obs.shape == (297,) and env.observation_space.contains(np.zeros(297, np.int32))
    a = int(np.flatnonzero(info["action_mask"])[0])
    obs, r, term, trunc, info = env.step(a)
    assert info["to_play"] == 1 and env.action_space.n == 45
    for mode in ("NextStep", "SameStep"):
        v = SplendaxVectorEnv(3, autoreset_mode=mode, backend=backend, device="cpu")
        obs, infos = v.reset(seed=1)
        assert v.observation_space.contains(obs) and v.action_space.shape == (3,)
        acts = np.array([np.flatnonzero(m)[0] for m in infos["action_mask"]])
        obs, r, term, trunc, infos = v.step(acts)
        assert obs.shape == (3, 297) and (infos["to_play"] == 1).all()
        v.close()
print("stand-ins ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=240)
    assert r.returncode == 0 and "stand-ins ok" in r.stdout, r.stdout + r.stderr


# -- the self-play wrappers -----------------------------------------------------


def seeded_opponent(seed):
    rng = np.random.RandomState(seed)

    def policy(obs, info):
        legal = np.flatnonzero(info["action_mask"])
        return int(rng.choice(legal)) if len(legal) else 0

    return policy


def play_wrapped(wrapper, seed, max_turns=300):
    rng = np.random.RandomState(seed)
    obs, info = wrapper.reset(seed=seed)
    total, rewards = 0.0, []
    for _ in range(max_turns):
        legal = np.flatnonzero(info["action_mask"])
        obs, r, term, trunc, info = wrapper.step(int(rng.choice(legal)) if len(legal) else 0)
        total += r
        rewards.append(r)
        if term or trunc:
            return total, info, rewards
    raise AssertionError("the game did not end")


def make_env_pair(backend, monkeypatch, tmp_path):
    """The port's env and the JAX package's on the same backend.

    The JAX package builds its native library into one temporary file that
    every process shares, and a process that loses that build race keeps the
    error for good (ROADMAP.md, section C).  Such a process retries the
    build once, into a directory of the test's own; a toolchain that cannot
    build the library still fails the test."""
    if backend != "native":
        return SplendorEnv(backend=backend, device="cpu"), JSplendorEnv(backend="jax")
    native._load()
    try:
        jenv = JSplendorEnv(backend="native")
    except RuntimeError:
        monkeypatch.setattr(jnative, "_build_error", None)
        monkeypatch.setenv("SPLENDAX_NATIVE_DIR", str(tmp_path))
        jenv = JSplendorEnv(backend="native")
    return SplendorEnv(backend=backend, device="cpu"), jenv


@pytest.mark.parametrize("backend", BACKENDS)
def test_selfplay_wrapper_matches_jax(backend, monkeypatch, tmp_path):
    """SelfPlayWrapper: the agent is player 0, the opponent's terminal
    reward is sign-flipped; the same episode as the JAX wrapper's."""
    env, jenv = make_env_pair(backend, monkeypatch, tmp_path)
    got = play_wrapped(wrappers.SelfPlayWrapper(env, seeded_opponent(1), random_starts=False), 5)
    want = play_wrapped(jwrappers.SelfPlayWrapper(jenv, seeded_opponent(1), random_starts=False), 5)
    assert got[0] == want[0] and got[2] == want[2]
    assert_same_info(got[1], want[1], "last step")
    assert got[0] in (1.0, -1.0, 0.0) or abs(abs(got[0]) - 0.1) < 1e-6
    w = wrappers.SelfPlayWrapper(env, wrappers.random_opponent, random_starts=False)
    obs, info = w.reset(seed=0)
    assert info["to_play"] == 0
    obs, r, term, trunc, info = w.step(int(np.flatnonzero(info["action_mask"])[0]))
    assert term or info["to_play"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_dual_step_selfplay_wrapper_matches_jax(backend, monkeypatch, tmp_path):
    env, jenv = make_env_pair(backend, monkeypatch, tmp_path)
    w = wrappers.DualStepSelfPlayWrapper(env, seeded_opponent(3), random_starts=False)
    jw = jwrappers.DualStepSelfPlayWrapper(jenv, seeded_opponent(3), random_starts=False)
    got, want = play_wrapped(w, 21), play_wrapped(jw, 21)
    assert got[2] == want[2]
    assert_same_info(got[1], want[1], "last turn")
    stats = w.get_wrapper_stats()
    assert stats == dict(jw.get_wrapper_stats())
    assert stats["total_agent_actions"] == stats["turn_count"]
    assert abs(stats["total_opponent_actions"] - stats["turn_count"]) <= 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_dual_step_native_wrapper_contract(backend, monkeypatch, tmp_path):
    """dual_step's 6-tuple on the port equals the JAX wrapper's, turn by
    turn, to the end of the game."""
    env, jenv = make_env_pair(backend, monkeypatch, tmp_path)
    w = wrappers.DualStepNativeWrapper(env, seeded_opponent(4), random_starts=False)
    jw = jwrappers.DualStepNativeWrapper(jenv, seeded_opponent(4), random_starts=False)
    rng = np.random.RandomState(1)
    obs, info = w.reset(seed=13)
    jw.reset(seed=13)
    for _ in range(300):
        legal = np.flatnonzero(info["action_mask"])
        a = int(rng.choice(legal)) if len(legal) else 0
        got, want = w.dual_step(a), jw.dual_step(a)
        for x, y in zip(got[:5], want[:5]):
            np.testing.assert_array_equal(x, y)
        assert_same_info(got[5], want[5], "dual_step info")
        info = got[5]
        if got[4]:
            fr = info["final_rewards"]
            assert got[1] == pytest.approx(fr[0]) or info["game_ended_on"] == "agent_move"
            assert got[3] == pytest.approx(fr[1]) or info["game_ended_on"] == "opponent_move"
            return
    raise AssertionError("the game did not end")


def test_make_env_builds_each_wrapper():
    for name, cls in (("selfplay", wrappers.SelfPlayWrapper),
                      ("dual", wrappers.DualStepSelfPlayWrapper),
                      ("dual_native", wrappers.DualStepNativeWrapper)):
        w = wrappers.make_env(wrapper=name, backend="torch", device="cpu")()
        assert isinstance(w, cls) and w.env.backend == "torch" and w.device.type == "cpu"
    with pytest.raises(ValueError):
        wrappers.make_env(wrapper="nope")


def test_frozen_policy_matches_jax():
    """The greedy host policy of an H=32 net against the JAX package's,
    over the states of a game: equal actions (top-two gaps checked)."""
    flat = numpy_params(np.random.RandomState(2), H)
    policy = wrappers.frozen_policy_from(ac.params_from_jax(flat, device="cpu"))
    jpolicy = jwrappers.frozen_policy_from(jax_params(flat))
    env = SplendorEnv(backend="torch", device="cpu")
    obs, info = env.reset(seed=4)
    for _ in range(40):
        a = policy(obs, info)
        logits, _ = jac.forward(jax_params(flat), jnp.asarray(obs)[None])
        ml = np.sort(np.asarray(jac.masked_logits(logits, jnp.asarray(info["action_mask"] > 0)[None]))[0])
        if ml[-1] - ml[-2] > 1e-4:
            assert a == jpolicy(obs, info)
        assert info["action_mask"][a]
        obs, _, term, _, info = env.step(a)
        if term:
            break


# -- the host heuristics ----------------------------------------------------------


class _Ref:
    def __init__(self, state):
        self.state = state


def test_host_heuristics_match_jax():
    """Each host heuristic against the JAX package's on the same obs and
    info, the tie-breaking ones after the same np.random seed; greedy_v2
    reads the bank from its env's state."""
    st, obs, mask = midgame(48, 50, 6)
    assert set(opponents.HOST_POLICIES) == set(jopp.HOST_POLICIES)
    for i in range(48):
        o, m = obs[i].numpy(), mask[i].numpy().astype(np.int8)
        info = {"action_mask": m}
        row = st.map(lambda x: x[i: i + 1])
        jrow = JGameState(**{k: jnp.asarray(v[0]) for k, v in S.to_numpy(row).items()})
        pairs = [(opponents.HOST_POLICIES[k], jopp.HOST_POLICIES[k]) for k in sorted(jopp.HOST_POLICIES)]
        pairs += [(opponents.greedy_opponent_v2_factory(_Ref(row)),
                   jopp.greedy_opponent_v2_factory(_Ref(jrow))),
                  (opponents.greedy_opponent_v2_factory(), jopp.greedy_opponent_v2_factory())]
        for k, (fn, jfn) in enumerate(pairs):
            np.random.seed(1000 * i + k)
            got = fn(o, info)
            np.random.seed(1000 * i + k)
            assert got == jfn(o, info) and type(got) is int, (i, k)
    empty = {"action_mask": np.zeros(45, np.int8)}
    for fn in list(opponents.HOST_POLICIES.values()) + [opponents.greedy_opponent_v2_factory()]:
        assert fn(obs[0].numpy(), empty) == 0

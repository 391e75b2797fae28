"""The generic CleanRL PPO in the port (`splendax_torch.train.ppo_generic`)
against the JAX package's (`splendax.train.ppo_generic`) on the CPU, and on
the port's own env through the gymnasium stand-ins of `env._gym`.

Tolerances: the actions the envs receive and the episode returns are equal
(the action is the argmax of logits + the same Gumbel noise, logits within
f32 rounding); the params after two updates within rtol/atol 1e-4."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gymnasium as gym
import jax

from splendax.train import ppo_generic as jpg
from splendax_torch.train import ppo_generic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--num-envs", "2", "--num-steps", "16", "--num-minibatches", "2", "--update-epochs", "2",
         "--total-timesteps", "64", "--seed", "3"]


def test_flags_and_defaults_equal_the_jax_cli():
    def table(parser_args):
        return vars(parser_args)

    assert table(ppo_generic.parse_args([])) == table(jpg.parse_args([]))
    for argv in (SMALL, ["--no-anneal-lr", "--target-kl", "0.01", "--env-id", "SplendaxTorch-v0"]):
        assert vars(ppo_generic.parse_args(argv)) == vars(jpg.parse_args(argv))


def jax_inputs(seed, num_envs, act_dim, obs_dim, hidden, n_steps):
    """JAX main's initial params and the Gumbel noise of each env step's
    `jax.random.categorical`, from the keys it splits."""
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    params = jpg.init_agent(k_init, obs_dim, act_dim, hidden)
    noise = []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(k, (num_envs, act_dim))))
    return jax.tree.map(np.asarray, params), noise


def recording_vector_env(monkeypatch):
    """gymnasium's SyncVectorEnv, recording the actions it is stepped with."""
    seen = []

    class Recording(gym.vector.SyncVectorEnv):
        def step(self, actions):
            seen.append(np.array(actions, np.int64))
            return super().step(actions)

    monkeypatch.setattr(gym.vector, "SyncVectorEnv", Recording)
    return seen


def test_cartpole_matches_jax(monkeypatch):
    """2 updates of 2 envs x 16 steps, 2 minibatches, 2 epochs: the same
    actions, the same episode returns, params within 1e-4."""
    seen = recording_vector_env(monkeypatch)
    jparams, jreturns = jpg.main(SMALL)
    want_actions = list(seen)
    seen.clear()
    init, noise = jax_inputs(3, 2, 2, 4, 64, 32)
    agent, returns = ppo_generic.main(SMALL, device="cpu", init_params=init, noise=noise)
    assert len(seen) == len(want_actions) == 32
    np.testing.assert_array_equal(np.stack(seen), np.stack(want_actions))
    assert returns == jreturns and len(returns) > 0
    layers = [lyr for head in ("critic", "actor") for lyr in jparams[head]]
    for layer, lyr in zip(agent.linears(), layers):
        np.testing.assert_allclose(layer.weight.detach().numpy().T, np.asarray(lyr["w"]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(lyr["b"]),
                                   rtol=1e-4, atol=1e-4)
    # And the noise really moved the sample: with zero noise the actions are greedy.
    assert not all((a == a[0]).all() for a in want_actions)


def test_init_agent_is_orthogonal_with_the_reference_gains():
    agent = ppo_generic.init_agent(torch.Generator().manual_seed(0), 4, 2, 64, device="cpu")
    gains = (np.sqrt(2), np.sqrt(2), 1.0, np.sqrt(2), np.sqrt(2), 0.01)
    for layer, gain in zip(agent.linears(), gains):
        w = layer.weight.detach().double()
        small = min(w.shape)
        gram = w @ w.T if w.shape[0] == small else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(small), atol=1e-5)
        assert not layer.bias.detach().any()


def test_gae_matches_jax_scan():
    """The reverse GAE loop against the JAX main's reverse scan body on the
    same rewards, values and dones."""
    rng = np.random.RandomState(0)
    T, N, gamma, lam = 12, 3, 0.99, 0.95
    r, v = rng.randn(T, N).astype(np.float32), rng.randn(T, N).astype(np.float32)
    d = (rng.rand(T, N) < 0.2).astype(np.float32)
    lv, ld = rng.randn(N).astype(np.float32), (rng.rand(N) < 0.5).astype(np.float32)

    def body(carry, xs):
        lastgaelam, next_value, next_nonterminal = carry
        reward, value, done = xs
        delta = reward + gamma * next_value * next_nonterminal - value
        lastgaelam = delta + gamma * lam * next_nonterminal * lastgaelam
        return (lastgaelam, value, 1.0 - done), lastgaelam

    _, want = jax.lax.scan(body, (np.zeros(N, np.float32), lv, 1.0 - ld), (r, v, d), reverse=True)
    adv, ret = ppo_generic.gae(*(torch.from_numpy(x) for x in (r, v, d, lv, ld)), gamma, lam)
    np.testing.assert_allclose(adv.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(want) + v, rtol=1e-6, atol=1e-6)


@pytest.mark.slow
def test_ppo_generic_learns_cartpole():
    """The CleanRL-parity vanilla PPO improves CartPole returns."""
    _, returns = ppo_generic.main(["--total-timesteps", "16384", "--seed", "1"], device="cpu")
    assert len(returns) > 5
    assert np.mean(returns[-5:]) > np.mean(returns[:5])


def run_without_gymnasium(code):
    r = subprocess.run([sys.executable, "-c", "import sys\nsys.modules['gymnasium'] = None\n" + code],
                       capture_output=True, text=True, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def play_vector(gym_module, make_env, seed=5, steps=400):
    """Two SplendaxTorch-v0 envs under RecordEpisodeStatistics in a
    SyncVectorEnv, random legal actions: each step's rewards, flags and the
    layout of its infos (every key's dtype, shape and values; the wall-time
    entry `t` by presence only)."""
    envs = gym_module.vector.SyncVectorEnv(
        [lambda: gym_module.wrappers.RecordEpisodeStatistics(make_env()) for _ in range(2)])
    rng = np.random.RandomState(seed)
    obs, infos = envs.reset(seed=seed)
    trace, ended = [], 0

    def layout(d):
        return {k: (layout(v) if isinstance(v, dict) else
                    (str(v.dtype), v.shape, None if k == "t" else v.tolist()))
                for k, v in sorted(d.items(), key=lambda kv: str(kv[0]))}

    for _ in range(steps):
        m = infos["action_mask"]
        acts = np.array([rng.choice(np.flatnonzero(row)) if row.any() else 0 for row in m])
        obs, r, term, trunc, infos = envs.step(acts)
        trace.append((obs.tolist(), r.tolist(), r.dtype.str, term.tolist(), trunc.tolist(),
                      layout(infos)))
        ended += "episode" in infos
    envs.close()
    return trace, ended


def test_standins_give_gymnasiums_info_layout():
    """SyncVectorEnv and RecordEpisodeStatistics stand-ins against gymnasium
    1.x on the same seeded games and actions, episode ends included."""
    import inspect
    import json

    code = "import json\nimport numpy as np\n" + inspect.getsource(play_vector) + """
from splendax_torch.env import _gym
from splendax_torch.env.gym_compat import SplendorEnv
assert not _gym.HAVE_GYMNASIUM
print(json.dumps(play_vector(_gym.gym, lambda: SplendorEnv(device="cpu"))))
"""
    got = json.loads(run_without_gymnasium(code))
    from splendax_torch.env.gym_compat import SplendorEnv

    want = play_vector(gym, lambda: SplendorEnv(device="cpu"))
    want = json.loads(json.dumps(want))
    assert want[1] > 0, "no episode ended"
    assert got == want


def test_ppo_generic_runs_on_splendax_without_gymnasium():
    """One update on SplendaxTorch-v0 through the stand-ins: gym.make, the
    episode statistics wrapper and the vector env."""
    out = run_without_gymnasium("""
from splendax_torch.env import _gym
from splendax_torch.env import gym_compat
from splendax_torch.train import ppo_generic
assert not _gym.HAVE_GYMNASIUM
try:
    _gym.gym.make("CartPole-v1")
    raise AssertionError("the stand-ins made an env they do not know")
except _gym.gym.error.Error as e:
    assert "need gymnasium" in str(e)
_gym.gym.register(gym_compat.ENV_ID, entry_point="splendax_torch.env.gym_compat:SplendorEnv",
                  kwargs={"device": "cpu"})
agent, returns = ppo_generic.main(["--env-id", "SplendaxTorch-v0", "--num-envs", "2",
                                   "--num-steps", "16", "--total-timesteps", "32",
                                   "--num-minibatches", "2", "--update-epochs", "1"], device="cpu")
assert agent.actor[-1].out_features == 45 and agent.critic[0].in_features == 297
print("ok", len(returns))
""")
    assert "update=1/1 SPS=" in out and out.splitlines()[-1].startswith("ok")


def test_ppo_generic_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppo_generic.main(SMALL)

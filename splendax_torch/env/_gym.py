"""gymnasium, or stand-ins for the parts of it the host envs use.

With gymnasium installed this module re-exports it.  Without it,
`gym_compat.SplendorEnv` and `vector.SplendaxVectorEnv` still construct,
reset and step: `Env` seeds its `np_random` as gymnasium does
(`np.random.default_rng(seed)`), `AutoresetMode` carries gymnasium's values,
and `spaces.Discrete`, `spaces.Box` and `batch_space` build shape-and-bounds
stand-ins for the two space types the envs declare.  `gym.register`,
`gym.make`, `gym.wrappers.RecordEpisodeStatistics` and
`gym.vector.SyncVectorEnv` (NEXT_STEP autoreset) stand in for what
`train.ppo_generic` calls, with gymnasium 1.x's info layout: every info key
batched over the envs beside its `_<key>` presence mask, dicts batched key by
key, so an ended episode shows as `infos["episode"]["r"]` and
`infos["_episode"]`.
"""

from __future__ import annotations

import enum
import importlib
import time

import numpy as np

try:
    import gymnasium as gym
    from gymnasium import spaces
    from gymnasium.vector import AutoresetMode, VectorEnv
    from gymnasium.vector.utils import batch_space

    HAVE_GYMNASIUM = True
except ImportError:
    HAVE_GYMNASIUM = False

    class _Space:
        def __init__(self, shape, dtype, low, high, n=None):
            self.shape, self.dtype, self.n = tuple(shape), np.dtype(dtype), n
            self.low = np.full(self.shape, low, self.dtype)
            self.high = np.full(self.shape, high, self.dtype)

        def contains(self, x) -> bool:
            x = np.asarray(x)
            return x.shape == self.shape and bool(((x >= self.low) & (x <= self.high)).all())

        __contains__ = contains

    class spaces:  # noqa: N801 - stands in for the gymnasium.spaces module
        @staticmethod
        def Discrete(n):  # noqa: N802
            return _Space((), np.int64, 0, n - 1, n=n)

        @staticmethod
        def Box(low, high, shape, dtype):  # noqa: N802
            return _Space(shape, dtype, low, high)

    def batch_space(space, n: int):
        return _Space((n,) + space.shape, space.dtype, space.low, space.high)

    class AutoresetMode(enum.Enum):
        NEXT_STEP = "NextStep"
        SAME_STEP = "SameStep"
        DISABLED = "Disabled"

    class gym:  # noqa: N801 - stands in for the gymnasium module
        class Env:
            metadata: dict = {}
            _np_random = None

            def reset(self, *, seed=None, options=None):
                if seed is not None:
                    self._np_random = np.random.default_rng(seed)
                return None, {}

            @property
            def np_random(self):
                if self._np_random is None:
                    self._np_random = np.random.default_rng()
                return self._np_random

            def close(self):
                pass

        class error:  # noqa: N801 - stands in for gymnasium.error
            Error = Exception

        _registry: dict = {}

        @staticmethod
        def register(id, entry_point, kwargs=None):  # noqa: A002 - gymnasium's name
            gym._registry[id] = (entry_point, dict(kwargs or {}))

        @staticmethod
        def make(id, **kwargs):  # noqa: A002
            if id not in gym._registry:
                raise gym.error.Error(f"{id!r} is not one of the stand-ins' envs "
                                      f"{sorted(gym._registry)}; other envs need gymnasium")
            entry_point, defaults = gym._registry[id]
            module, name = entry_point.split(":")
            return getattr(importlib.import_module(module), name)(**{**defaults, **kwargs})

    class VectorEnv:
        metadata: dict = {}
        closed = False

        def close(self, **kwargs):
            if not self.closed:
                self.close_extras(**kwargs)
                self.closed = True

        def close_extras(self, **kwargs):
            pass

    def _add_info(infos: dict, info: dict, i: int, n: int) -> dict:
        """Env i's info into the batched infos, as gymnasium's
        `VectorEnv._add_info` does it."""
        for key, value in info.items():
            if isinstance(value, dict):
                array = _add_info(infos.get(key, {}), value, i, n)
            else:
                array = infos.get(key)
                if array is None:
                    if type(value) in (int, float, bool) or isinstance(value, np.number):
                        array = np.zeros(n, dtype=type(value))
                    elif isinstance(value, np.ndarray):
                        array = np.zeros((n,) + value.shape, dtype=value.dtype)
                    else:
                        array = np.full(n, None, dtype=object)
                array[i] = value
            present = infos.get(f"_{key}", np.zeros(n, dtype=np.bool_))
            present[i] = True
            infos[key], infos[f"_{key}"] = array, present
        return infos

    class _RecordEpisodeStatistics:
        """Adds `info["episode"] = {"r", "l", "t"}` at the end of an
        episode: its return, its length and its wall seconds."""

        def __init__(self, env):
            self.env = env
            self.observation_space, self.action_space = env.observation_space, env.action_space

        def reset(self, **kwargs):
            self.episode_returns, self.episode_lengths = 0.0, 0
            self.episode_start_time = time.perf_counter()
            return self.env.reset(**kwargs)

        def step(self, action):
            obs, reward, terminated, truncated, info = self.env.step(action)
            self.episode_returns += reward
            self.episode_lengths += 1
            if terminated or truncated:
                info["episode"] = {"r": self.episode_returns, "l": self.episode_lengths,
                                   "t": round(time.perf_counter() - self.episode_start_time, 6)}
            return obs, reward, terminated, truncated, info

        def close(self):
            self.env.close()

    class _SyncVectorEnv(VectorEnv):
        """The envs of `env_fns` stepped one after another, with NEXT_STEP
        autoreset: an env that ended at step t is reset at step t+1, its
        action ignored, reward 0."""

        def __init__(self, env_fns):
            self.envs = [fn() for fn in env_fns]
            self.num_envs = len(self.envs)
            self.single_observation_space = self.envs[0].observation_space
            self.single_action_space = self.envs[0].action_space
            self._autoreset = np.zeros(self.num_envs, dtype=np.bool_)

        def reset(self, *, seed=None, options=None):
            seeds = [None if seed is None else seed + i for i in range(self.num_envs)]
            self._autoreset[:] = False
            obs, infos = [], {}
            for i, (env, s) in enumerate(zip(self.envs, seeds)):
                o, info = env.reset(seed=s, options=options)
                obs.append(o)
                infos = _add_info(infos, info, i, self.num_envs)
            return np.stack(obs), infos

        def step(self, actions):
            n = self.num_envs
            obs, infos = [], {}
            rewards = np.zeros(n, np.float64)
            terms, truncs = np.zeros(n, np.bool_), np.zeros(n, np.bool_)
            for i, env in enumerate(self.envs):
                if self._autoreset[i]:
                    o, info = env.reset()
                else:
                    o, rewards[i], terms[i], truncs[i], info = env.step(actions[i])
                obs.append(o)
                infos = _add_info(infos, info, i, n)
            self._autoreset = terms | truncs
            return np.stack(obs), rewards, terms, truncs, infos

        def close_extras(self, **kwargs):
            for env in self.envs:
                env.close()

    gym.wrappers = type("wrappers", (), {"RecordEpisodeStatistics": _RecordEpisodeStatistics})
    gym.vector = type("vector", (), {"SyncVectorEnv": _SyncVectorEnv})

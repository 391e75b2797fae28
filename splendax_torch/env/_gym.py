"""gymnasium, or stand-ins for the parts of it the host envs use.

With gymnasium installed this module re-exports it.  Without it,
`gym_compat.SplendorEnv` and `vector.SplendaxVectorEnv` still construct,
reset and step: `Env` seeds its `np_random` as gymnasium does
(`np.random.default_rng(seed)`), `AutoresetMode` carries gymnasium's values,
and `spaces.Discrete`, `spaces.Box` and `batch_space` build shape-and-bounds
stand-ins for the two space types the envs declare.
"""

from __future__ import annotations

import enum

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

    class VectorEnv:
        metadata: dict = {}
        closed = False

        def close(self, **kwargs):
            if not self.closed:
                self.close_extras(**kwargs)
                self.closed = True

        def close_extras(self, **kwargs):
            pass

"""Native (C++) host engine bindings.

Counterpart of `splendax/native/__init__.py`, over this package's own copy
of `engine.cpp`: a C++ implementation of the rules, bit-identical to the
engine in parity mode, for the latency-bound host path (one game stepped
from Python, or N games stepped in one OpenMP-parallel call), where a
per-step device dispatch would cap interactive stepping.

Bindings are ctypes.  The library is compiled with g++ on first use from the
source in this checkout into `build/native/` beside the package (or
`$SPLENDAX_TORCH_NATIVE_DIR`), keyed by the source hash.  Each process
compiles into a temporary file of its own and moves it into place with
`os.replace`, so processes that build at once cannot race.  `is_available()`
is False when the library cannot be built; `_load()` raises then.

This is host code: it has no CUDA counterpart, and the tables come from the
port's `engine/data`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "engine.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")

STATE_SIZE = 194  # int32 words; must match engine.cpp State (static_assert'd)
OBS_DIM = 297
TOTAL_ACTIONS = 45

# Flat int32 layout of engine.cpp's State (field -> (offset, shape)).
STATE_LAYOUT = {
    "bank": (0, (6,)),
    "tokens": (6, (2, 6)),
    "bonuses": (18, (2, 5)),
    "prestige": (28, (2,)),
    "reserved_ids": (30, (2, 3)),
    "reserved_revealed": (36, (2, 3)),
    "reserved_count": (42, (2,)),
    "player_nobles": (44, (2, 3)),
    "noble_ids": (50, (3,)),
    "board": (53, (3, 4)),
    "deck_perm": (65, (3, 40)),
    "deck_count": (185, (3,)),
    "to_play": (188, ()),
    "turn_count": (189, ()),
    "move_count": (190, ()),
    "game_over": (191, ()),
    "winner": (192, ()),
    "turn_limit_reached": (193, ()),
}

# Flags returned by spx_env_step.
F_TERMINATED, F_ILLEGAL, F_DRAW, F_TURN_LIMIT = 1, 2, 4, 8

_I32P = ctypes.POINTER(ctypes.c_int32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_INT, _I32, _I64 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64
# engine.cpp's extern "C" entry points: (name, restype, argtypes).
_SIGNATURES = (
    ("spx_init_tables", None, [_I32P] * 8),
    ("spx_state_size", _INT, []),
    ("spx_initial_state", None, [_I64, _I32P]),
    ("spx_legal_mask", None, [_I32P, _I8P]),
    ("spx_encode_obs", None, [_I32P, _I32P]),
    ("spx_is_terminal", _INT, [_I32P]),
    ("spx_env_step", _INT, [_I32P, _I32, _I32P, _I8P, _F64P]),
    ("spx_final_rewards", None, [_I32P, _F64P]),
    ("spx_random_game", _INT, [_I64, _INT, _I32P]),
    ("spx_initial_state_batch", None, [_I64P, _INT, _I32P]),
    ("spx_legal_mask_batch", None, [_I32P, _INT, _I8P]),
    ("spx_encode_obs_batch", None, [_I32P, _INT, _I32P]),
    ("spx_env_step_batch", None,
     [_I32P, _I32P, _I8P, _I64P, _INT, _I32P, _I8P, _F64P, _I32P, _F64P]),
)

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> str:
    """Compile engine.cpp into a shared library keyed by its source hash;
    return its path."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.environ.get("SPLENDAX_TORCH_NATIVE_DIR", _BUILD_DIR)
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, f"libspxengine-{tag}.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        base = ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC]
        try:
            # -fopenmp parallelises the spx_*_batch entry points across host
            # threads; lanes are independent, so results are identical
            # without it.  Retry without it only when the failure is about
            # OpenMP: a real source error must surface.
            subprocess.run(base[:1] + ["-fopenmp"] + base[1:], check=True,
                           capture_output=True)
        except subprocess.CalledProcessError as e:
            err = (e.stderr or b"").decode(errors="replace").lower()
            if "openmp" not in err and "gomp" not in err:
                raise
            subprocess.run(base, check=True, capture_output=True)
        os.replace(tmp, lib_path)
    return lib_path


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _i8p(a: np.ndarray):
    return a.ctypes.data_as(_I8P)


def _load() -> ctypes.CDLL:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None)
        _build_error = repr(e) + (f": {detail.decode(errors='replace')}" if detail else "")
        raise RuntimeError(f"native engine unavailable: {_build_error}") from e

    for name, restype, argtypes in _SIGNATURES:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    if lib.spx_state_size() != STATE_SIZE:
        raise RuntimeError("native engine: the state layout drifted")

    from ..engine import data as D

    tables = [np.ascontiguousarray(t, np.int32) for t in (
        D.CARD_COST, D.CARD_COLOR, D.CARD_POINTS, D.CARD_TIER, D.NOBLE_REQ,
        D.NOBLE_POINTS, D.COMBO_MASK, D.DEFAULT_BANK)]
    lib.spx_init_tables(*[_i32p(t) for t in tables])
    _lib = lib
    return lib


def is_available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _unflatten(flat: np.ndarray, name: str):
    off, shape = STATE_LAYOUT[name]
    n = int(np.prod(shape)) if shape else 1
    v = flat[..., off: off + n]
    return v.reshape(flat.shape[:-1] + shape) if shape else v[..., 0]


class NativeGame:
    """One Splendor game on the native engine (numpy in and out).

    The flat `state` array is the single source of truth; `to_game_state()`
    gives it as the port's `GameState` with B=1.
    """

    def __init__(self, seed: int):
        self._lib = _load()
        self.state = np.zeros(STATE_SIZE, np.int32)
        self._obs = np.zeros(OBS_DIM, np.int32)
        self._mask = np.zeros(TOTAL_ACTIONS, np.int8)
        self._reward = ctypes.c_double(0.0)
        self._lib.spx_initial_state(int(seed), _i32p(self.state))

    def legal_mask(self) -> np.ndarray:
        self._lib.spx_legal_mask(_i32p(self.state), _i8p(self._mask))
        return self._mask.copy()

    def observation(self) -> np.ndarray:
        self._lib.spx_encode_obs(_i32p(self.state), _i32p(self._obs))
        return self._obs.copy()

    def is_terminal(self) -> bool:
        return bool(self._lib.spx_is_terminal(_i32p(self.state)))

    def env_step(self, action: int) -> Tuple[np.ndarray, float, int, np.ndarray]:
        """(obs, reward, flags, mask) with the reference env contract."""
        flags = self._lib.spx_env_step(_i32p(self.state), int(action), _i32p(self._obs),
                                       _i8p(self._mask), ctypes.byref(self._reward))
        return self._obs.copy(), float(self._reward.value), int(flags), self._mask.copy()

    def final_rewards(self) -> Tuple[float, float]:
        out = np.zeros(2, np.float64)
        self._lib.spx_final_rewards(_i32p(self.state), out.ctypes.data_as(_F64P))
        return float(out[0]), float(out[1])

    def field(self, name: str) -> np.ndarray:
        return _unflatten(self.state, name)

    def to_game_state(self, device="cuda"):
        """The game as the port's `GameState` with B=1 on `device`."""
        from ..engine.state import FIELDS, from_numpy

        arrays = {}
        for name in FIELDS:  # copies: the flat state is stepped in place
            v = np.array(_unflatten(self.state, name))[None]
            arrays[name] = v.astype(bool) if name in ("game_over", "turn_limit_reached") else v
        return from_numpy(arrays, device)


class NativeBatch:
    """N independent Splendor games stepped in ONE native call.

    The C loop (`spx_env_step_batch`) is OpenMP-parallel across host
    threads and bit-identical to stepping N `NativeGame`s one by one.  The
    host vector path of `env.vector.SplendaxVectorEnv(backend="native")`."""

    def __init__(self, n: int):
        self._lib = _load()
        self.n = int(n)
        self.states = np.zeros((n, STATE_SIZE), np.int32)
        self._obs = np.zeros((n, OBS_DIM), np.int32)
        self._mask = np.zeros((n, TOTAL_ACTIONS), np.int8)
        self._reward = np.zeros(n, np.float64)
        self._flags = np.zeros(n, np.int32)
        self._final = np.zeros((n, 2), np.float64)

    def reset(self, seeds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Re-init ALL lanes from int64 engine seeds; (obs, mask) copies."""
        seeds = np.ascontiguousarray(seeds, np.int64)
        if seeds.shape != (self.n,):
            raise ValueError(f"seeds must have shape ({self.n},), got {seeds.shape}")
        self._lib.spx_initial_state_batch(seeds.ctypes.data_as(_I64P), self.n, _i32p(self.states))
        self._lib.spx_encode_obs_batch(_i32p(self.states), self.n, _i32p(self._obs))
        self._lib.spx_legal_mask_batch(_i32p(self.states), self.n, _i8p(self._mask))
        return self._obs.copy(), self._mask.copy()

    def step(self, actions: np.ndarray, reset_lane: Optional[np.ndarray] = None,
             reset_seeds: Optional[np.ndarray] = None):
        """Step every lane; lanes with reset_lane[i] become fresh games from
        reset_seeds[i] instead (their action ignored: gymnasium NEXT_STEP).

        Returns (obs, mask, reward f64[n], flags i32[n], final_rewards
        f64[n, 2]) as copies; flags bits: 1=terminated 2=illegal 4=draw
        8=turn_limit."""
        actions = np.ascontiguousarray(actions, np.int32)
        if actions.shape != (self.n,):
            raise ValueError(f"actions must have shape ({self.n},), got {actions.shape}")
        if reset_lane is None:
            lane_p = seed_p = None
        else:
            reset_lane = np.ascontiguousarray(reset_lane, np.int8)
            reset_seeds = np.ascontiguousarray(reset_seeds, np.int64)
            if reset_lane.shape != (self.n,) or reset_seeds.shape != (self.n,):
                raise ValueError(
                    f"reset_lane/reset_seeds must have shape ({self.n},), got "
                    f"{reset_lane.shape}/{reset_seeds.shape}")
            lane_p = _i8p(reset_lane)
            seed_p = reset_seeds.ctypes.data_as(_I64P)
        self._lib.spx_env_step_batch(
            _i32p(self.states), _i32p(actions), lane_p, seed_p, self.n, _i32p(self._obs),
            _i8p(self._mask), self._reward.ctypes.data_as(_F64P), _i32p(self._flags),
            self._final.ctypes.data_as(_F64P),
        )
        return (self._obs.copy(), self._mask.copy(), self._reward.copy(),
                self._flags.copy(), self._final.copy())

    def reset_lanes(self, idx, seeds) -> None:
        """Re-init a SUBSET of lanes in place (SAME_STEP autoreset); the
        other lanes are untouched."""
        for i, s in zip(np.asarray(idx), np.asarray(seeds)):
            self._lib.spx_initial_state(int(s), _i32p(self.states[int(i)]))

    def lane_obs_mask(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(obs, mask) of one lane's CURRENT state."""
        obs = np.zeros(OBS_DIM, np.int32)
        mask = np.zeros(TOTAL_ACTIONS, np.int8)
        row = self.states[int(i)]
        self._lib.spx_encode_obs(_i32p(row), _i32p(obs))
        self._lib.spx_legal_mask(_i32p(row), _i8p(mask))
        return obs, mask

    def to_play(self) -> np.ndarray:
        return self.states[:, STATE_LAYOUT["to_play"][0]].copy()


def random_game(seed: int, max_plies: int = 400) -> Tuple[int, np.ndarray]:
    """Play a full uniform-random-legal game natively; (plies, final_state)."""
    lib = _load()
    final = np.zeros(STATE_SIZE, np.int32)
    plies = lib.spx_random_game(int(seed), int(max_plies), _i32p(final))
    return int(plies), final

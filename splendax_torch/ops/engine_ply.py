"""The engine's fast-mode ply on the card: the transition, the observation
encode and the legal mask in hand-written CUDA (`csrc/engine_ply.cu`).

Two kernels, each one launch for a whole batch:

  * `step` -- `env/core.step_core` (the action clamp, legality from the given
    mask or the state's own, `rules.apply_action` with the fast-mode token
    return, the pick for illegal and no-move rows, the outcome fields), or
    `rules.apply_action` alone (`apply_only`); a lane may keep its state
    (`hold`, or `freeze_terminal` for a game already over, as the playouts
    freeze their lanes); optionally the next state's observation and legal
    mask (`& ~terminated` with `mask_live`, as `core.step` gives it);
  * `observe` -- `encode_observation` and `legal_mask`, optionally of
    `core.select(done, fresh, state)` (the carried state returned too) or
    with the mask `& ~done` (`mask_off`).

A step may repeat each game `repeat` times in a row (a search's children),
an observe gather its lanes (`rows`, as the Gumbel search's lanes); either
then returns the output state, which it writes whole.

`takes(x, rng_mode)` is the dispatch: a CUDA tensor in fast mode takes the
kernels.  The call sites (`rules.apply_action`, `core.step_core`,
`core.step`, `selfplay/dual`'s plies, `search/gumbel` and `search/mc`) ask it
and otherwise run the plain PyTorch functions (`rules.apply_action_plain`,
`core.step_core_plain`, ...), which stay the CPU's and parity mode's path
and what the kernels are held against, bit for bit.

The kernels write fresh tensors and never write in place.  The next state of
a `step` whose rows do not move shares the input's `deck_perm` (the ply
never changes it); every other field is new.  Counters (`splendax_torch.trace`):
`engine_ply.launches.step` and `engine_ply.launches.observe`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import trace
from ..engine.state import FIELDS, GameState
from . import _build, engine_tables

OBS = 297
NA = 45
APPLY_ONLY, FREEZE_TERMINAL, MASK_LIVE, SELECT, MASK_OFF = 1, 2, 4, 8, 16
SHAPES = {field: shape for field, _, shape in engine_tables.LAYOUT}  # a game's, in order
BOOLS = ("game_over", "turn_limit_reached")
assert tuple(SHAPES) == FIELDS

_Fields = ctypes.c_void_p * len(FIELDS)


class _Args(ctypes.Structure):
    """`PlyArgs` of `csrc/engine_ply.cu`."""

    _fields_ = [("inp", _Fields), ("fresh", _Fields), ("out", _Fields),
                *[(n, ctypes.c_void_p) for n in (
                    "action", "mask", "rows", "flag", "reward", "terminated", "illegal", "draw",
                    "turn_limit", "final_rewards", "obs", "mask_out")],
                ("n", ctypes.c_longlong), ("repeat", ctypes.c_longlong), ("flags", ctypes.c_int)]


def __getattr__(name: str):
    """`launches`: {"step": n, "observe": n}, read from `splendax_torch.trace`."""
    if name == "launches":
        return {k: trace.counter("engine_ply.launches." + k) for k in ("step", "observe")}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def takes(x: torch.Tensor, rng_mode: str) -> bool:
    """Whether a call on tensor `x` takes the kernels: on the card, in fast
    mode (parity mode's token return draws from MT19937 on the host)."""
    return rng_mode == "fast" and x.device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("engine_ply")
    for name in ("engine_step", "engine_observe"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.engine_ply_args_size.restype = ctypes.c_longlong
    if lib.engine_ply_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("engine_ply: the kernel's argument layout differs from the binding's")
    err = lib.engine_ply_init()
    if err != 0:
        raise RuntimeError(f"engine_ply: setting the kernels' shared memory: CUDA error {err}")
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _inputs(state: GameState, what: str) -> dict:
    """The state's fields, checked and contiguous."""
    B = state.to_play.shape[0] if state.to_play.dim() == 1 else -1
    dev = state.to_play.device
    out = {}
    for name, x in state.items():
        dtype = torch.bool if name in BOOLS else torch.int32
        if x.dtype != dtype or tuple(x.shape) != (B,) + SHAPES[name] or x.device != dev:
            raise ValueError(f"engine_ply.{what}: {name} must be {dtype} {[B, *SHAPES[name]]} "
                             f"on {dev}, got {x.dtype} {list(x.shape)} on {x.device}")
        out[name] = x.contiguous()
    return out


def _per_lane(x, n: int, what: str, name: str, dtype=torch.bool):
    if x is None:
        return None
    if x.dtype != dtype or tuple(x.shape) != (n,) or x.device.type != "cuda":
        raise ValueError(f"engine_ply.{what}: {name} must be {dtype} [{n}] on the card, got "
                         f"{x.dtype} {list(x.shape)} on {x.device}")
    return x.contiguous()


def _out_state(n: int, dev, deck) -> dict:
    return {name: (deck if name == "deck_perm" and deck is not None else torch.empty(
        (n,) + shape, dtype=torch.bool if name in BOOLS else torch.int32, device=dev))
        for name, shape in SHAPES.items()}


def _launch(kernel: str, args: _Args, dev) -> None:
    if args.n == 0:
        return
    err = getattr(_lib(), kernel)(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    trace.count("engine_ply.launches." + kernel[len("engine_"):])


def step(state: GameState, action: torch.Tensor, mask=None, *, apply_only: bool = False,
         repeat: int = 1, hold=None, freeze_terminal: bool = False,
         with_obs: bool = False, with_mask: bool = False, mask_live: bool = False):
    """One transition a lane on the card, in one launch.

    `state` [B] on the card; `action` int [N], N = B * repeat (lane g plays
    from game g // repeat); `mask` bool [N, 45] the state's legal mask
    (repeat 1), else the kernel computes it.  `hold` bool [N]: lanes that
    keep their state (their outcome fields are the transition's, as
    `core.step_core`'s before a select, but `to_play`, the next state's).
    Returns (next_state, fields, obs, next_mask): `fields` the outcome of
    `core.step_core` (None with `apply_only`), obs and next_mask None unless
    asked for."""
    what = "step"
    ins = _inputs(state, what)
    dev = state.to_play.device
    if repeat < 1:
        raise ValueError(f"engine_ply.step: repeat must be at least 1, got {repeat}")
    n = state.to_play.shape[0] * repeat
    if dev.type != "cuda":
        raise ValueError(f"engine_ply.step: the kernels run on the card, not {dev}")
    if action.dim() != 1 or action.shape[0] != n or action.device != dev \
            or action.dtype.is_floating_point or action.dtype == torch.bool:
        raise ValueError(f"engine_ply.step: action must be an int tensor [{n}] on {dev}, got "
                         f"{action.dtype} {list(action.shape)} on {action.device}")
    action = action.to(torch.int64).contiguous()
    if apply_only and (mask is not None or hold is not None or freeze_terminal or mask_live):
        raise ValueError("engine_ply.step: apply_only takes no mask, hold, freeze or live mask")
    if mask is not None:
        if repeat != 1:
            raise ValueError("engine_ply.step: a given mask needs repeat 1")
        if mask.dtype != torch.bool or tuple(mask.shape) != (n, NA) or mask.device != dev:
            raise ValueError(f"engine_ply.step: mask must be bool [{n}, {NA}] on {dev}, got "
                             f"{mask.dtype} {list(mask.shape)} on {mask.device}")
        mask = mask.contiguous()
    hold = _per_lane(hold, n, what, "hold")
    mapped = repeat != 1
    out = _out_state(n, dev, None if mapped else ins["deck_perm"])
    a = _Args()
    a.inp[:] = [ins[k].data_ptr() for k in FIELDS]
    a.out[:] = [None if (k == "deck_perm" and not mapped) else out[k].data_ptr() for k in FIELDS]
    a.action, a.mask, a.flag = action.data_ptr(), _ptr(mask), _ptr(hold)
    fields = None
    if not apply_only:
        f32 = dict(dtype=torch.float32, device=dev)
        b8 = dict(dtype=torch.bool, device=dev)
        fields = dict(reward=torch.empty(n, **f32), terminated=torch.empty(n, **b8),
                      to_play=out["to_play"], illegal_action=torch.empty(n, **b8),
                      draw=torch.empty(n, **b8), turn_limit=torch.empty(n, **b8),
                      final_rewards=torch.empty((n, 2), **f32))
        a.reward, a.terminated = fields["reward"].data_ptr(), fields["terminated"].data_ptr()
        a.illegal, a.draw = fields["illegal_action"].data_ptr(), fields["draw"].data_ptr()
        a.turn_limit = fields["turn_limit"].data_ptr()
        a.final_rewards = fields["final_rewards"].data_ptr()
    obs = torch.empty((n, OBS), dtype=torch.int32, device=dev) if with_obs else None
    next_mask = torch.empty((n, NA), dtype=torch.bool, device=dev) if with_mask else None
    a.obs, a.mask_out = _ptr(obs), _ptr(next_mask)
    a.n, a.repeat = n, repeat
    a.flags = ((APPLY_ONLY if apply_only else 0) | (FREEZE_TERMINAL if freeze_terminal else 0)
               | (MASK_LIVE if mask_live else 0))
    _launch("engine_step", a, dev)
    return GameState(**out), fields, obs, next_mask


def observe(state: GameState, *, rows=None, fresh=None, done=None, with_obs: bool = True,
            mask_off: bool = False):
    """The observation and the legal mask of each lane on the card, in one
    launch.  `rows` (int64 [N]) gathers the lanes first; `fresh` (a
    GameState like `state`) with `done` (bool [B]) observes
    `core.select(done, fresh, state)`; `mask_off` gives the mask `& ~done`.
    Returns (lanes' state or None, obs or None, mask): the state when rows
    or fresh make a new one, obs unless `with_obs` is false."""
    what = "observe"
    ins = _inputs(state, what)
    dev = state.to_play.device
    if dev.type != "cuda":
        raise ValueError(f"engine_ply.observe: the kernels run on the card, not {dev}")
    B = state.to_play.shape[0]
    n = B if rows is None else rows.shape[0]
    rows = _per_lane(rows, n, what, "rows", torch.int64)
    if fresh is not None and rows is not None:
        raise ValueError("engine_ply.observe: give rows or fresh, not both")
    if (fresh is not None or mask_off) and done is None:
        raise ValueError("engine_ply.observe: fresh and mask_off need done")
    done = _per_lane(done, n, what, "done")
    fr = _inputs(fresh, what) if fresh is not None else None
    if fr is not None and (fr["to_play"].shape[0] != B or fresh.to_play.device != dev):
        raise ValueError(f"engine_ply.observe: fresh must hold {B} games on {dev}")
    new_state = rows is not None or fresh is not None
    out = _out_state(n, dev, None) if new_state else None
    a = _Args()
    a.inp[:] = [ins[k].data_ptr() for k in FIELDS]
    if fr is not None:
        a.fresh[:] = [fr[k].data_ptr() for k in FIELDS]
    if out is not None:
        a.out[:] = [out[k].data_ptr() for k in FIELDS]
    a.rows, a.flag = _ptr(rows), _ptr(done)
    obs = torch.empty((n, OBS), dtype=torch.int32, device=dev) if with_obs else None
    mask = torch.empty((n, NA), dtype=torch.bool, device=dev)
    a.obs, a.mask_out = _ptr(obs), mask.data_ptr()
    a.n, a.repeat = n, 1
    a.flags = (SELECT if fresh is not None else 0) | (MASK_OFF if mask_off else 0)
    _launch("engine_observe", a, dev)
    return (GameState(**out) if out is not None else None), obs, mask

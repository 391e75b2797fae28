"""Ring row take: rows[i] = packed[ptr + min(rank[i], window - 1)].

Counterpart of the TPU kernel `splendax/ops/ring_take.py`.  On a CUDA tensor
`take_rows` launches the hand-written kernel in `csrc/ring_take.cu`; on a CPU
tensor it runs `take_rows_plain`, the same function in plain PyTorch, which
is also what the kernel is held against.  `launches` counts kernel launches
(counter `kernel_b.launches` of `splendax_torch.trace`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import trace
from . import _build

WIDTH = 135  # bytes of a packed game state; the kernel is built for this width


def __getattr__(name: str):
    """`launches`, read from `splendax_torch.trace`."""
    if name == "launches":
        return trace.counter("kernel_b.launches")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def take_rows_plain(packed: torch.Tensor, ptr: torch.Tensor, rank: torch.Tensor, window: int):
    return packed[ptr + torch.clamp(rank, max=window - 1)]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("ring_take")
    fn = lib.ring_take_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def take_rows(packed: torch.Tensor, ptr: torch.Tensor, rank: torch.Tensor, window: int):
    """int8 rows [B, width] of `packed` (int8 [R + window, width]) at
    `ptr + min(rank, window - 1)`; `ptr` is an int64 scalar tensor and `rank`
    int64 [B], all on one device."""
    if packed.device.type == "cpu":
        return take_rows_plain(packed, ptr, rank, window)
    if packed.device.type != "cuda":
        raise ValueError(f"take_rows: unsupported device {packed.device}")
    for name, t, dt in (("packed", packed, torch.int8), ("ptr", ptr, torch.int64), ("rank", rank, torch.int64)):
        if t.device != packed.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"take_rows: {name} must be contiguous {dt} on {packed.device}")
    if packed.dim() != 2 or ptr.numel() != 1 or rank.dim() != 1:
        raise ValueError("take_rows: expected packed [R, width], scalar ptr, rank [B]")
    if packed.shape[1] != WIDTH or max(packed.numel(), rank.shape[0] * WIDTH) >= 2**31:
        raise ValueError(f"take_rows: the kernel takes rows of {WIDTH} bytes and 32-bit "
                         f"offsets, got packed {tuple(packed.shape)}, {rank.shape[0]} ranks")
    if not 1 <= window <= packed.shape[0]:
        raise ValueError(f"take_rows: window {window} outside [1, {packed.shape[0]}]")
    B = rank.shape[0]
    rows = torch.empty((B, WIDTH), dtype=torch.int8, device=packed.device)
    err = _lib()(
        packed.data_ptr(), ptr.data_ptr(), rank.data_ptr(), B, WIDTH, window,
        rows.data_ptr(), torch.cuda.current_stream(packed.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ring_take kernel launch failed: CUDA error {err}")
    trace.count("kernel_b.launches")
    return rows

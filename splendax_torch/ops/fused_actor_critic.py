"""Fused masked actor-critic forward.

Counterpart of the TPU kernel `splendax/ops/fused_actor_critic.py`: both MLPs
(297 -> H -> H -> 45 actor, 297 -> H -> H -> 1 critic, tanh after the first
two layers) and the masked-logits select in one pass.  On a CUDA tensor
`fused_masked_forward` launches the hand-written kernel in
`csrc/fused_actor_critic.cu` (3xTF32 on the tensor cores); on a CPU tensor it
runs `fused_masked_forward_plain`, the same function in plain PyTorch.  The
kernel is held within rtol/atol 1e-5 of the plain version, which computes in
the weights' dtype: on the committed nets the plain float32 version is
itself that far from the exact forward, so float64 weights give the
reference.  `launches` counts kernel launches.

`weights` is the list of the 12 weight and bias tensors in the JAX package's
layout, [in, out]: aw0 ab0 aw1 ab1 aw2 ab2 cw0 cb0 cw1 cb1 cw2 cb2
(`models.actor_critic.kernel_weights` builds it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

OBS_DIM = 297
ACT_DIM = 45
BIG_NEG = -1e9
MAX_HIDDEN = 1024

launches = 0


def masked_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Illegal actions -> -1e9; rows with no legal action left unmasked."""
    any_legal = mask.any(-1, keepdim=True)
    return torch.where(mask | ~any_legal, logits, BIG_NEG)


def fused_masked_forward_plain(weights, obs, mask, with_value: bool = True):
    """The forward in plain PyTorch, in the weights' dtype: float32 as the
    kernel takes them, or float64 for a reference closer to exact."""
    aw0, ab0, aw1, ab1, aw2, ab2, cw0, cb0, cw1, cb1, cw2, cb2 = weights
    x = obs.to(aw0.dtype)
    h = torch.tanh(x @ aw0 + ab0)
    h = torch.tanh(h @ aw1 + ab1)
    logits = masked_logits(h @ aw2 + ab2, mask)
    if not with_value:
        return logits, None
    v = torch.tanh(x @ cw0 + cb0)
    v = torch.tanh(v @ cw1 + cb1)
    return logits, (v @ cw2 + cb2)[:, 0]


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("fused_actor_critic").fused_actor_critic_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(weights, obs, mask):
    dev = obs.device
    if obs.dtype != torch.int32 or obs.dim() != 2 or obs.shape[1] != OBS_DIM:
        raise ValueError(f"obs must be int32 [B, {OBS_DIM}], got {obs.dtype} {tuple(obs.shape)}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (obs.shape[0], ACT_DIM):
        raise ValueError(f"mask must be bool [B, {ACT_DIM}], got {mask.dtype} {tuple(mask.shape)}")
    if len(weights) != 12:
        raise ValueError("weights must hold 12 tensors")
    H = weights[0].shape[1]
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden width {H} outside [1, {MAX_HIDDEN}]")
    shapes = [(OBS_DIM, H), (H,), (H, H), (H,), (H, ACT_DIM), (ACT_DIM,),
              (OBS_DIM, H), (H,), (H, H), (H,), (H, 1), (1,)]
    for i, (w, s) in enumerate(zip(weights, shapes)):
        if tuple(w.shape) != s or w.dtype != torch.float32 or w.device != dev:
            raise ValueError(f"weights[{i}] must be float32 {s} on {dev}, got "
                             f"{w.dtype} {tuple(w.shape)} on {w.device}")
    for name, t in [("obs", obs), ("mask", mask)] + [(f"weights[{i}]", w) for i, w in enumerate(weights)]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    return H


def fused_masked_forward(weights, obs: torch.Tensor, mask: torch.Tensor, with_value: bool = True):
    """(weights, int32 obs [B, 297], bool mask [B, 45]) -> (masked logits
    f32 [B, 45], value f32 [B], or None when `with_value` is False, which
    skips the critic)."""
    if obs.device.type == "cpu":
        return fused_masked_forward_plain(weights, obs, mask, with_value)
    global launches
    if obs.device.type != "cuda":
        raise ValueError(f"fused_masked_forward: unsupported device {obs.device}")
    H = _check(weights, obs, mask)
    B = obs.shape[0]
    logits = torch.empty((B, ACT_DIM), dtype=torch.float32, device=obs.device)
    value = torch.empty((B,), dtype=torch.float32, device=obs.device) if with_value else None
    if B == 0:
        return logits, value
    ptrs = (ctypes.c_void_p * 12)(*[w.data_ptr() for w in weights])
    err = _lib()(
        obs.data_ptr(), mask.data_ptr(), B, H, ptrs, logits.data_ptr(),
        value.data_ptr() if with_value else None,
        torch.cuda.current_stream(obs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_actor_critic kernel launch failed: CUDA error {err}")
    launches += 1
    return logits, value

"""The plain actor-critic forward: 297 -> H -> H -> {45 logits, 1 value},
tanh after the first two layers of each head, in a precision of choice.

Weights come from the committed `.npz` files (the JAX package's key layout
`actor.0.w` ... `critic.2.b`, weights [in, out]), read here and never from
the program.  A precision is one of:

  * "f64": every product and sum in float64, the reference;
  * "tf32": float32 with the products on TF32 (10 mantissa bits): the
    control, one precision below the configurations' float32.  On the card
    cuBLAS computes them with TF32 switched on, forward and backward; on
    the CPU, which has no TF32, the forward's operands are rounded to it by
    hand (the gradient passes the rounding unchanged);
  * "f32": plain float32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

HEADS = ("actor", "critic")
BIG_NEG = -1e9
ACT_DIM = 45
PRECISIONS = ("f64", "tf32", "f32")


def dtype_of(prec: str) -> torch.dtype:
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}, not one of {PRECISIONS}")
    return torch.float64 if prec == "f64" else torch.float32


def load_npz(path: str, device) -> list:
    """The 12 weights and biases of an npz, float64 on `device`, in the order
    aw0 ab0 aw1 ab1 aw2 ab2 cw0 cb0 cw1 cb1 cw2 cb2 ([in, out] weights)."""
    with np.load(path) as data:
        return [torch.as_tensor(np.asarray(data[f"{h}.{j}.{p}"], np.float64), device=device)
                for h in HEADS for j in range(3) for p in ("w", "b")]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


@contextlib.contextmanager
def tf32_matmuls(on: bool):
    """cuBLAS's TF32 switch for float32 products, restored on exit."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _tf32_operand(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to TF32 in the forward, unchanged in the gradient."""
    return x + (round_tf32(x.detach()) - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """x @ w + b in `prec` (x already in its dtype)."""
    dt = dtype_of(prec)
    w, b = w.to(dt), b.to(dt)
    if prec == "tf32" and not x.is_cuda:
        return _tf32_operand(x) @ _tf32_operand(w) + b
    with tf32_matmuls(prec == "tf32"):
        return x @ w + b


def masked_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Illegal actions -> -1e9; rows with no legal action left unmasked."""
    any_legal = mask.any(-1, keepdim=True)
    return torch.where(mask | ~any_legal, logits, BIG_NEG)


def forward(weights, obs: torch.Tensor, mask: torch.Tensor | None, prec: str = "f64",
            with_value: bool = True):
    """-> (logits [B, 45], masked where `mask` is given, value [B] or None),
    in `prec`'s dtype."""
    aw0, ab0, aw1, ab1, aw2, ab2, cw0, cb0, cw1, cb1, cw2, cb2 = weights
    x = obs.to(dtype_of(prec))
    h = torch.tanh(linear(x, aw0, ab0, prec))
    h = torch.tanh(linear(h, aw1, ab1, prec))
    logits = linear(h, aw2, ab2, prec)
    if mask is not None:
        logits = masked_logits(logits, mask)
    if not with_value:
        return logits, None
    v = torch.tanh(linear(x, cw0, cb0, prec))
    v = torch.tanh(linear(v, cw1, cb1, prec))
    return logits, linear(v, cw2, cb2, prec)[:, 0]


def forward_rows(weights, obs, mask, prec: str = "f64", with_value: bool = True,
                 block: int = 32768):
    """`forward` in blocks of `block` rows, so a large batch fits beside
    the program's memory."""
    if obs.shape[0] <= block:
        return forward(weights, obs, mask, prec, with_value)
    parts = [forward(weights, obs[i:i + block], None if mask is None else mask[i:i + block],
                     prec, with_value) for i in range(0, obs.shape[0], block)]
    logits = torch.cat([p[0] for p in parts])
    return logits, (torch.cat([p[1] for p in parts]) if with_value else None)


def gumbel_noise(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel draws f32 `shape`: -log(-log(u)), u uniform in (0, 1),
    one `torch.rand` call on `generator`."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))

"""Threefry-2x32 and `jax.random.uniform`'s bit-to-float rule, in torch.

The fast-mode token return (`ops/token_return.return_tokens_plain`; on the
card the ply's kernel, `csrc/engine_ply.cu`, draws the same bits) seeds a threefry key
from the game state and draws its uniforms from it.  This module reproduces
`jax.random.uniform(wrap_key_data([hi, lo], impl="threefry2x32"), (n,))` bit
for bit, so the port's engine matches the JAX engine exactly in fast mode.

torch has no full uint32 arithmetic, so every word is held in int64 and
masked to 32 bits after each add and shift.  The counters follow JAX's
partitionable layout: draw i hashes the 64-bit count i split as (hi=0, lo=i),
and its 32 random bits are the XOR of the two output words.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under key
    (k0, k1).  All arguments are int64 tensors holding uint32 values and
    broadcast together; returns the two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def uniform_from_key_words(hi: torch.Tensor, lo: torch.Tensor, n: int) -> torch.Tensor:
    """f32[..., n] uniforms in [0, 1), equal bit for bit to
    `jax.random.uniform(wrap_key_data([hi, lo], impl="threefry2x32"), (n,))`
    for each key; `hi` and `lo` are int64 tensors of uint32 words."""
    k0 = hi.to(torch.int64)[..., None]
    k1 = lo.to(torch.int64)[..., None]
    count = torch.arange(n, dtype=torch.int64, device=hi.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(count), count)
    bits = y0 ^ y1
    # 23 random mantissa bits under the exponent of 1.0 give a float in
    # [1, 2); minus 1 gives [0, 1).  int32 holds the bit pattern exactly
    # because it is below 2**31.
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0)

"""CPython's `random.Random` (MT19937) on batched tensors.

Counterpart of `splendax/engine/mt19937.py`.  The engine's only in-game
randomness is the token return: a `random.Random(seed)` seeded from a hash
of the state and consumed through `_randbelow`.  For `rng_mode="parity"`
this module reproduces CPython's Mersenne Twister bit for bit, for L lanes
at once:

  * `random.seed(int)`: abs(seed) split into 32-bit little-endian words,
    then `init_by_array`;
  * `getrandbits(k <= 32)`: one tempered 32-bit word shifted right by 32 - k;
  * `Random._randbelow_with_getrandbits(n)`: rejection sampling with
    k = n.bit_length().

torch has no full uint32 arithmetic, so every word is an int64 masked to 32
bits after each product and sum.  The two passes of `init_by_array` are
sequential by nature (each word feeds the next): 623 steps each, every step
a few vector operations over the lanes.  The twist has dependencies of
limited range and is three vector blocks and one word.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace

N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _init_genrand_words(seed: int = 19650218) -> tuple:
    """mt[0] = seed; mt[i] = 1812433253 * (mt[i-1] ^ (mt[i-1] >> 30)) + i.
    The same for every stream, so computed once on the host."""
    mt = [seed & M32]
    for i in range(1, N):
        prev = mt[-1]
        mt.append((1812433253 * (prev ^ (prev >> 30)) + i) & M32)
    return tuple(mt)


def _init_by_array(key2: torch.Tensor, keylen: torch.Tensor) -> torch.Tensor:
    """CPython's init_by_array for keys of one or two words: key2 int64
    [L, 2], keylen int64 [L] (1 or 2) -> mt int64 [L, 624]."""
    L = key2.shape[0]
    dev = key2.device
    base = trace.sync("mt19937.init", lambda: torch.as_tensor(
        np.asarray(_init_genrand_words(), np.int64), device=dev))  # a pageable copy
    mt = [base[i].expand(L) for i in range(N)]

    # Pass 1: 624 steps at i = 1..623, then 1 again after the wrap; j cycles
    # over the key's words.
    j_seq = torch.arange(N, device=dev)[None] % keylen[:, None]  # [L, 624]
    addend = (key2.gather(1, j_seq) + j_seq) & M32

    def f1(prev, mt_i, kt):
        return ((mt_i ^ (((prev ^ (prev >> 30)) * 1664525) & M32)) + kt) & M32

    prev = mt[0]
    for step in range(N - 1):
        prev = mt[step + 1] = f1(prev, mt[step + 1], addend[:, step])
    mt[0] = mt[N - 1]
    mt[1] = f1(mt[0], mt[1], addend[:, N - 1])

    # Pass 2: 623 steps at i = 2..623, then 1 after the wrap.
    def f2(prev, mt_i, i):
        return ((mt_i ^ (((prev ^ (prev >> 30)) * 1566083941) & M32)) - i) & M32

    prev = mt[1]
    for i in range(2, N):
        prev = mt[i] = f2(prev, mt[i], i)
    mt[0] = mt[N - 1]
    mt[1] = f2(mt[0], mt[1], 1)
    mt[0] = torch.full((L,), _UPPER, dtype=torch.int64, device=dev)
    return torch.stack(mt, dim=1)


def _twist(mt: torch.Tensor) -> torch.Tensor:
    """The next block of 624 words, [L, 624] -> [L, 624].

    new[i] = far ^ twist(mt[i], mt[i + 1]) with far = new_or_old[(i + 397) %
    624]: an old word for i < 227, a new one 227 places behind otherwise, so
    the block splits into A = [0, 227), B1 = [227, 454), B2 = [454, 623) and
    the last word."""

    def tw(cur, nxt, far):
        y = (cur & _UPPER) | (nxt & _LOWER)
        return far ^ (y >> 1) ^ (_MATRIX_A * (y & 1))

    K = N - _M  # 227
    a = tw(mt[:, :K], mt[:, 1 : K + 1], mt[:, _M:])
    b1 = tw(mt[:, K : 2 * K], mt[:, K + 1 : 2 * K + 1], a)
    b2 = tw(mt[:, 2 * K : N - 1], mt[:, 2 * K + 1 : N], b1[:, : N - 1 - 2 * K])
    last = tw(mt[:, N - 1], a[:, 0], b1[:, _M - 1 - K])
    return torch.cat([a, b1, b2, last[:, None]], dim=1)


def _temper(y: torch.Tensor) -> torch.Tensor:
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    return y ^ (y >> 18)


def init_from_seed_words(seed_lo: torch.Tensor, seed_hi: torch.Tensor):
    """The first block of tempered outputs of `random.Random(seed)` for
    seed = seed_hi * 2**32 + seed_lo, both int64 [L] holding uint32 values.
    Returns the stream (block int64 [L, 624], ptr int64 [L]); the token
    return consumes far fewer than 624 words, so one block suffices."""
    key2 = torch.stack([seed_lo & M32, seed_hi & M32], dim=1)
    keylen = torch.where(seed_hi > 0, 2, 1)
    block = _temper(_twist(_init_by_array(key2, keylen)))
    return block, torch.zeros_like(seed_lo)


_BITLEN = (0, 1, 2, 2, 3, 3)  # n.bit_length() for n in 0..5


def randbelow(stream, n: torch.Tensor, active=None):
    """CPython's `Random._randbelow_with_getrandbits` for 1 <= n <= 5 on
    every lane -> (stream, r int64 [L]).  Each lane consumes as many
    `getrandbits(k)` draws as CPython would; a lane where `active` is False
    draws nothing and returns 0.  One host read per round of rejections."""
    block, ptr = stream
    L = n.shape[0]
    ar = torch.arange(L, device=n.device)
    k = trace.sync("mt19937.bitlen", lambda: torch.as_tensor(_BITLEN, device=n.device))[
        n.clamp(0, 5)]  # a pageable copy
    shift = 32 - k
    need = torch.ones_like(n, dtype=torch.bool) if active is None else active.clone()
    r = torch.zeros_like(n)
    while trace.sync("mt19937.randbelow", need.any().item):
        draw = block[ar, ptr.clamp(max=N - 1)] >> shift
        r = torch.where(need, draw, r)
        ptr = ptr + need.long()
        need = need & (draw >= n)
    return (block, ptr), r


def py_randbelow_reference(seed: int, ns):
    """The same draws from CPython's own `random` (for tests)."""
    import random

    rng = random.Random(seed)
    return [rng._randbelow(n) for n in ns]

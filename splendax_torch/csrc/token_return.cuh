// The fast-mode token return of one game, as a device function: the mover
// gives back tokens until holding at most 10, each draw returning one token
// of a colour chosen uniformly among the colours held, gold only once no
// other colour is left.  `engine_ply.cu` draws it inside the transition,
// the same bits as `ops/token_return.return_tokens_plain` and the JAX
// engine's fast mode (`splendax/engine/rules.py:_auto_return_tokens`).
//
// The draws come from threefry-2x32 keyed by a hash of the game state.  One
// thread carries one game: it hashes the state into the key as the engine
// does, then computes draw i (a pure function of the key and i) only when
// the game needs it, so a game under the cap, most of them, draws nothing.
// Every word is uint32, the float product is `__fmul_rn` so nothing is
// contracted, and the colour is the (r+1)-th held one by a running count.

#pragma once

#include <cstdint>

namespace token_return_dev {

constexpr int MAX_RETURNS = 12;  // draws per token return; a hand never exceeds 22 tokens
constexpr int TOKEN_CAP = 10;
constexpr int GOLD = 5;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The Threefry-2x32 hash (20 rounds) of counter (0, i) under key (k0, k1);
// returns the XOR of its two output words, the draw's 32 random bits.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = ks[0], x1 = i + ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[r % 2][j]) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + (uint32_t)(r + 1);
  }
  return x0 ^ x1;
}

// The token return of the player to move: `t` their 6 token counts and `b`
// the bank's 6, both updated in place; `mover` is to_play and `turn` the
// game's turn_count, as the state hash reads them.
__device__ __forceinline__ void return_tokens(int t[6], int b[6], int32_t mover, int32_t turn) {
  uint32_t held = 0u, pooled = 0u;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    held += (uint32_t)t[c];
    pooled += (uint32_t)b[c];
  }
  const int k = (int)held - TOKEN_CAP > 0 ? (int)held - TOKEN_CAP : 0;
  int returned = 0;
  if (k > 0) {
    // The state hash's seed words, as the JAX engine computes them: the
    // turn's product in 16-bit limbs (hi is that form's, not the product's
    // true high word), the other terms XORed into the low word.
    const uint32_t tc = (uint32_t)turn;
    const uint32_t a = tc * (1315423911u >> 16);
    const uint32_t m = tc * (1315423911u & 0xFFFFu);
    uint32_t lo = (a << 16) + m;
    const uint32_t hi = (a + (m >> 16)) >> 16;
    lo ^= (uint32_t)mover * 2654435761u;
    lo ^= held * 97531u;
    lo ^= pooled * 31337u;
    for (int i = 0; i < MAX_RETURNS && returned < k; ++i) {
      int n = 0;
#pragma unroll
      for (int c = 0; c < 5; ++c) n += t[c] > 0;
      if (n == 0) break;
      // 23 random mantissa bits under the exponent of 1.0, minus 1: [0, 1).
      float u = __fsub_rn(__uint_as_float((threefry_bits(hi, lo, (uint32_t)i) >> 9) | 0x3F800000u),
                          1.0f);
      u = u < 0.0f ? 0.0f : u;
      int r = (int)__fmul_rn(u, (float)n);
      r = r < n - 1 ? r : n - 1;
      int color = 0, seen = 0;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        if (t[c] > 0) {
          if (seen == r) color = c;
          ++seen;
        }
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) {  // registers, not a dynamically indexed array
        if (c == color) {
          --t[c];
          ++b[c];
        }
      }
      ++returned;
    }
  }
  // Gold as the last resort.
  int give = k - returned > 0 ? k - returned : 0;
  give = give < t[GOLD] ? give : t[GOLD];
  t[GOLD] -= give;
  b[GOLD] += give;
}

}  // namespace token_return_dev

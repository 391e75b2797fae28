// Fast-mode token return: the mover gives back tokens until holding at most
// 10, each draw returning one token of a colour chosen uniformly among the
// colours held, gold only once no other colour is left.
//
// The kernel of `rules._auto_return_tokens` in fast mode on the card; its
// plain version is `ops/token_return.return_tokens_plain`, and it equals it,
// and the JAX engine (`splendax/engine/rules.py:_auto_return_tokens`), bit for
// bit.  The port's own: the JAX engine has no TPU kernel here (XLA fuses the
// unrolled loop into the step).
//
// Bound on Hopper: launch latency.  A lane reads its game's 12 held tokens, 6
// bank counts, the mover and the turn (80 bytes) and writes 18 counts (72
// bytes); at the league's B = 8192 that is 1.2 MB, 0.4 us at 3.35 TB/s.  The
// plain version spends ~516 launches on it, most of them the 20-round
// threefry over all 12 draws and 12 masked draw steps with an int64 scan
// each.  Here one thread carries one game: it hashes the state into the
// threefry key as the engine does, then computes draw i (a pure function of
// the key and i) only when the lane needs it, so a lane under the cap, most
// of them, draws nothing.  Every word is uint32, the float product is
// `__fmul_rn` so nothing is contracted, and the colour is the (r+1)-th held
// one by a running count.  The outputs are fresh tensors: a GameState's
// fields may be shared with other states, so nothing is written in place.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
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

__global__ void __launch_bounds__(THREADS)
token_return_kernel(const int32_t* __restrict__ tokens, const int32_t* __restrict__ bank,
                    const int32_t* __restrict__ to_play, const int32_t* __restrict__ turn_count,
                    int64_t B, int32_t* __restrict__ tokens_out, int32_t* __restrict__ bank_out) {
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (g >= B) return;
  const int32_t* tg = tokens + 12 * g;
  const int32_t* bg = bank + 6 * g;
  const int32_t mover = __ldg(to_play + g);
  const int p = mover != 0;
  int t[6], b[6], other[6];
  uint32_t held = 0u, pooled = 0u;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    t[c] = __ldg(tg + 6 * p + c);
    other[c] = __ldg(tg + 6 * (1 - p) + c);
    b[c] = __ldg(bg + c);
    held += (uint32_t)t[c];
    pooled += (uint32_t)b[c];
  }
  const int k = (int)held - TOKEN_CAP > 0 ? (int)held - TOKEN_CAP : 0;
  int returned = 0;
  if (k > 0) {
    // The state hash's seed words, as the JAX engine computes them: the
    // turn's product in 16-bit limbs (hi is that form's, not the product's
    // true high word), the other terms XORed into the low word.
    const uint32_t turn = (uint32_t)__ldg(turn_count + g);
    const uint32_t a = turn * (1315423911u >> 16);
    const uint32_t m = turn * (1315423911u & 0xFFFFu);
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
  int32_t* to = tokens_out + 12 * g;
  int32_t* bo = bank_out + 6 * g;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    to[6 * p + c] = t[c];
    to[6 * (1 - p) + c] = other[c];
    bo[c] = b[c];
  }
}

}  // namespace

// tokens int32 [B, 2, 6], bank int32 [B, 6], to_play and turn_count int32
// [B], all contiguous; writes tokens_out [B, 2, 6] and bank_out [B, 6]
// int32, which must not alias the inputs.  Returns cudaGetLastError().
extern "C" int token_return(const void* tokens, const void* bank, const void* to_play,
                            const void* turn_count, long long B, void* tokens_out,
                            void* bank_out, void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  token_return_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tokens, (const int32_t*)bank, (const int32_t*)to_play,
      (const int32_t*)turn_count, (int64_t)B, (int32_t*)tokens_out, (int32_t*)bank_out);
  return (int)cudaGetLastError();
}

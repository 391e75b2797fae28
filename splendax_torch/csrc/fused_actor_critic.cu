// Fused masked actor-critic forward on Hopper's tensor cores, at f32 accuracy.
//
// Replaces the TPU kernel `splendax/ops/fused_actor_critic.py:37` (`_kernel`,
// `fused_masked_forward`): the int32 -> f32 observation cast, the actor MLP
// 297 -> H -> H -> 45 and the critic MLP 297 -> H -> H -> 1 with tanh after
// the first two layers of each, and the masked-logits select (illegal ->
// -1e9; a row with no legal action stays unmasked).
//
// Bound on an H100 SXM: operations.  At B = 8192, H = 768 with the critic the
// six products are 2 B (2·297 H + 2 H² + 46 H) = 27.4 GFLOP, against 6.7 MB of
// weights and 12 MB of obs, mask and outputs.  On the f32 CUDA cores
// (67 TFLOP/s) that is 0.409 ms.  This kernel takes three TF32 products for
// each f32 one, which on the TF32 tensor cores (494.7 TFLOP/s dense) is at
// least 3 × 27.4 GFLOP in 0.166 ms.
//
// Numerics (3xTF32).  Each f32 operand a is split into hi = tf32(a) (cvt.rna)
// and lo = tf32(a - hi), and a·b is taken as lo·hi + hi·lo + hi·hi with
// `mma.sync.m16n8k8` TF32 products.  The products of one k-step of 8 are
// summed on the tensor cores from zero, and each k-step's sum is added to the
// accumulator in f32 on the CUDA cores, rounded to nearest: chained across
// all of K, the tensor cores' own f32 accumulation drifts past the 1e-5
// contract on the committed nets.  What the split drops (lo·lo, and what
// neither half keeps) is a few 2^-22 of |a·b|, less than the rounding of an
// f32 sum of hundreds of terms: on the committed nets the kernel is closer
// to the exact forward than the plain f32 version, and within rtol/atol 1e-5
// of the plain version in float64 (chip_smoke.py prints both;
// tests/test_torch_precision.py emulates this arithmetic on the CPU and
// shows that one TF32 product alone is far outside).  Weights are
// split in registers after they are loaded, so only f32 weights cross L2.
// Observations are integers: an integer of magnitude <= 2048 has at most 11
// significant bits and is exact in TF32, so its lo is 0 and layer 1's lo·hi
// product is exactly zero.  A block whose obs all satisfy |x| <= 2048 (every
// obs the engine encodes: token, bonus and card counts, points, deck sizes
// and turn counters) skips that product; any other block takes all three.
// The value head (one column) is an f32 FMA dot product.
//
// Tile.  A block takes M = 32 rows (M = 16 where that takes no more waves of
// blocks over the SMs) with 8 warps.  Shared memory holds the f32 obs tile
// (M x 312), the whole first hidden layer (M x (H + 8), H padded to 16) and
// a 3-stage ring of weight tiles (16 k-rows x 256 columns) fed by cp.async,
// zero-filled past the edges.  At M = 32 that is 39,936 + 99,328 + 49,920 = 189,184 B at
// H = 768 and 221,952 B at H = 1024 (under 227 KB; one block per SM).  A
// pass computes 256 output columns, 32 per warp.  The second hidden layer is
// never stored: each warp applies bias and tanh to its accumulators and
// multiplies them at once into the logits (45 padded to 48) and the value.
// An m16n8 accumulator is, up to a permutation of k, the A operand of an
// m16n8k8 product, so this needs no shuffle and no scratch.  The warps'
// partial heads are summed in a fixed order through shared memory.
//
// L2 traffic is the other limit: every block streams all the weights from
// L2 (6.7 MB at H = 768), so a call reads (B / M) x 6.7 MB: 256 blocks and
// 1.7 GB at B = 8192; at B = 2048, 128 blocks of 16 rows and 0.86 GB.  On an
// H100 the compute alone and the weight loads alone each take most of the
// kernel's time (scripts/torch_kernel_a_probe.py); sharing each weight tile
// between the blocks of a cluster, and wgmma, are the next steps.
//
// Probe switches.  scripts/torch_kernel_a_probe.py builds variants of this
// file with -D to see where the time goes; the library is built with none.
// PROBE_ROWS=16 or 32 fixes the row tile; PROBE_ONE_PRODUCT takes one TF32
// product for each f32 one (wrong numbers: a third of the tensor work);
// PROBE_NO_LOADS never copies a weight tile (wrong numbers: the compute
// alone).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OBS = 297;
constexpr int ACT = 45;
constexpr int HEAD_TILES = 6;  // 45 logits padded to 48: six n-tiles of 8
constexpr int HEAD_PAD = 8 * HEAD_TILES;
constexpr int K1P = 304;       // OBS rounded up to a whole ring stage
constexpr int SX = K1P + 8;    // obs tile row stride in floats (= 8 mod 16: no bank conflicts)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NC = 32 * WARPS;  // output columns per pass, 32 per warp
constexpr int KC = 16;          // k-rows per ring stage
constexpr int SW = NC + 4;      // ring row stride in floats (= 4 mod 16)
constexpr int STAGES = 3;
constexpr int STAGE = KC * SW;
constexpr int MAX_HIDDEN = 1024;
constexpr float BIG_NEG = -1e9f;
constexpr float TF32_EXACT = 2048.f;  // integers up to this magnitude are exact in TF32

static_assert(WARPS * 32 * HEAD_PAD <= STAGES * STAGE, "head partials must fit in the ring");

// Row stride of the first hidden layer in shared memory: H padded to a whole
// ring stage, plus 8 (= 8 mod 16: no bank conflicts).
__host__ __device__ constexpr int hidden_stride(int H) { return (H + KC - 1) / KC * KC + 8; }

template <int MT>
constexpr size_t smem_bytes(int H) {
  return sizeof(float) * ((size_t)16 * MT * (SX + hidden_stride(H)) + STAGES * STAGE);
}

struct Params {
  const float* w[12];  // aw0 ab0 aw1 ab1 aw2 ab2 cw0 cb0 cw1 cb1 cw2 cb2, [in, out]
};

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// d += a b: a 16x8 (row), b 8x8 (col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, from zero.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d += a b for one k-step at f32 accuracy: lo·hi (skipped when a is exact in
// TF32), hi·lo and hi·hi summed on the tensor cores from zero, then added to
// d on the CUDA cores, rounded to nearest.
template <bool A_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
#ifdef PROBE_ONE_PRODUCT
  mma(d, ah, bh0, bh1);
#else
  float s[4];
  if constexpr (A_EXACT) {
    mma0(s, ah, bl0, bl1);
  } else {
    mma0(s, al, bh0, bh1);
    mma(s, ah, bl0, bl1);
  }
  mma(s, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Ring stage <- W[k0 : k0 + KC, n0 : n0 + NC] of the row-major [K, N] W, with
// zeros past K and N.  VEC copies 16 bytes at a time (N % 4 == 0 and W
// 16-byte aligned), else 4.
template <bool VEC>
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ W, int K, int N,
                                           int k0, int n0) {
#ifdef PROBE_NO_LOADS
  return;
#endif
  constexpr int PER = VEC ? 4 : 1;
#pragma unroll
  for (int i = 0; i < KC * NC / PER / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / (NC / PER), col = c % (NC / PER) * PER;
    const int k = k0 + r, n = n0 + col;
    const bool ok = k < K && n < N;
    const float* src = ok ? W + (size_t)k * N + n : W;
    if constexpr (VEC)
      cp_async16(st + r * SW + col, src, ok);
    else
      cp_async4(st + r * SW + col, src, ok);
  }
}

// acc = A[0:M, 0:K] W[0:K, n0 : n0 + NC] for this warp's 32 columns.  A is in
// shared memory (row stride SA, zeros in columns K up to the next multiple of
// KC); W streams through the ring.  Fragment order: in each k-step of 8, the
// mma's k index j < 4 is memory column 2j and j + 4 is 2j + 1, so a thread
// reads its A pair with one 8-byte load; n-tile nt's column c is the warp's
// column 4c + nt, so a thread reads its four B values (one per n-tile) with
// one 16-byte load.  acc[mt][nt][i] is row 16 mt + g + 8 (i / 2), column
// n0 + 32 warp + 4 (2t + i % 2) + nt, for lane = 4g + t.
template <int MT, bool VEC, bool A_EXACT>
__device__ __forceinline__ void gemm_pass(const float* As, int SA, int K, const float* __restrict__ W, int N,
                          int n0, float* ring, float (&acc)[MT][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const bool active = n0 + 32 * warp < N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int nk = (K + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage<VEC>(ring + s * STAGE, W, K, N, s * KC, n0);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kc landed for all; stage kc - 1 is free
    const int next = kc + STAGES - 1;
    if (next < nk) load_stage<VEC>(ring + next % STAGES * STAGE, W, K, N, next * KC, n0);
    cp_async_commit();
    if (!active) continue;
    const float* st = ring + kc % STAGES * STAGE + 32 * warp + 4 * g;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      const float4 w0 = *reinterpret_cast<const float4*>(st + (ks + 2 * t) * SW);
      const float4 w1 = *reinterpret_cast<const float4*>(st + (ks + 2 * t + 1) * SW);
      const float wa[4] = {w0.x, w0.y, w0.z, w0.w}, wb[4] = {w1.x, w1.y, w1.z, w1.w};
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split(wa[nt], bh[nt][0], bl[nt][0]);
        split(wb[nt], bh[nt][1], bl[nt][1]);
      }
      const float* a = As + kc * KC + ks + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float2 top = *reinterpret_cast<const float2*>(a + (16 * mt + g) * SA);
        const float2 bot = *reinterpret_cast<const float2*>(a + (16 * mt + g + 8) * SA);
        const float av[4] = {top.x, bot.x, top.y, bot.y};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (A_EXACT) {
            ah[i] = __float_as_uint(av[i]);
            al[i] = 0u;
          } else {
            split(av[i], ah[i], al[i]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma3<A_EXACT>(acc[mt][nt], ah, al, bh[nt][0], bh[nt][1], bl[nt][0], bl[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before the next pass fills it
}

// Column of accumulator element (nt, i) of this thread, as gemm_pass lays it out.
__device__ __forceinline__ int acc_col(int n0, int nt, int i) {
  const int lane = threadIdx.x & 31;
  return n0 + 32 * (threadIdx.x >> 5) + 4 * (2 * (lane & 3) + (i & 1)) + nt;
}

// acc <- tanh(acc + bias); columns at or past H come out 0 (their weights and
// bias read as 0).
template <int MT>
__device__ __forceinline__ void bias_tanh(float (&acc)[MT][4][4], const float* __restrict__ bias,
                                          int H, int n0) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = acc_col(n0, nt, i);
      const float b = col < H ? __ldg(bias + col) : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) acc[mt][nt][i] = tanhf(acc[mt][nt][i] + b);
    }
}

// First hidden layer: h1 = tanh(x W + b), all H columns, into shared memory.
template <int MT, bool VEC>
__device__ __forceinline__ void hidden1(const float* xs, bool exact, const float* __restrict__ W,
                        const float* __restrict__ b, int H, float* h1, int SH, float* ring) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  float acc[MT][4][4];
  for (int n0 = 0; n0 < H; n0 += NC) {
    if (exact)
      gemm_pass<MT, VEC, true>(xs, SX, OBS, W, H, n0, ring, acc);
    else
      gemm_pass<MT, VEC, false>(xs, SX, OBS, W, H, n0, ring, acc);
    bias_tanh<MT>(acc, b, H, n0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = acc_col(n0, nt, i);
        if (col >= SH - 8) continue;  // past the padded width; a warp past H stores nothing
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) h1[(16 * mt + g + 8 * (i >> 1)) * SH + col] = acc[mt][nt][i];
      }
  }
}

// logits += h2 W2[cols, 0:45] for this warp's 32 columns of h2.  The h2
// accumulator of n-tile nt is the A operand of a head k-step as it stands:
// k index j < 4 is h2 column 4 (2j) + nt of the warp's 32 and j + 4 is
// column 4 (2j + 1) + nt, which picks the rows of W2.
template <int MT>
__device__ __forceinline__ void logit_update(const float (&h2)[MT][4][4], const float* __restrict__ W2, int H,
                             int n0, float (&out)[MT][HEAD_TILES][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float av[4] = {h2[mt][nt][0], h2[mt][nt][2], h2[mt][nt][1], h2[mt][nt][3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(av[i], ah[mt][i], al[mt][i]);
    }
    const int r0 = n0 + 32 * (threadIdx.x >> 5) + 8 * t + nt, r1 = r0 + 4;
#pragma unroll
    for (int hn = 0; hn < HEAD_TILES; ++hn) {
      const int n = 8 * hn + g;
      uint32_t bh0, bl0, bh1, bl1;
      split(r0 < H && n < ACT ? __ldg(W2 + r0 * ACT + n) : 0.f, bh0, bl0);
      split(r1 < H && n < ACT ? __ldg(W2 + r1 * ACT + n) : 0.f, bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma3<false>(out[mt][hn], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
}

// value partials (rows 16 mt + g + 8 j) += h2 wv over this thread's columns, in f32.
template <int MT>
__device__ __forceinline__ void value_update(const float (&h2)[MT][4][4],
                                             const float* __restrict__ wv, int H, int n0,
                                             float (&out)[MT][2]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = acc_col(n0, nt, i);
      const float w = col < H ? __ldg(wv + col) : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) out[mt][i >> 1] = fmaf(h2[mt][nt][i], w, out[mt][i >> 1]);
    }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_ac_kernel(const int32_t* __restrict__ obs, const uint8_t* __restrict__ mask, int B, int H,
                Params p, float* __restrict__ logits, float* __restrict__ value) {
  constexpr int M = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const int SH = hidden_stride(H);
  float* xs = smem;             // [M, SX] obs as f32, zeros past OBS and past the last row
  float* h1 = xs + M * SX;      // [M, SH] first hidden layer
  float* ring = h1 + M * SH;    // STAGES weight tiles; head partials at the end
  __shared__ int any_legal[M];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * M;
  const int rows = min(M, B - row0);

  int big = 0;
  for (int i = tid; i < M * K1P; i += THREADS) {
    const int r = i / K1P, c = i - r * K1P;
    const float x = r < rows && c < OBS ? (float)__ldg(obs + (size_t)(row0 + r) * OBS + c) : 0.f;
    xs[r * SX + c] = x;
    big |= fabsf(x) > TF32_EXACT;
  }
  if (tid < M) {
    int any = 0;
    if (tid < rows)
      for (int j = 0; j < ACT; ++j) any |= mask[(size_t)(row0 + tid) * ACT + j];
    any_legal[tid] = any;
  }
  const bool exact = !__syncthreads_or(big);

  // Actor: h1 into shared memory, then h2 a pass at a time into the logits.
  float acc[MT][4][4];
  float lg[MT][HEAD_TILES][4] = {};
  hidden1<MT, VEC>(xs, exact, p.w[0], p.w[1], H, h1, SH, ring);
  for (int n0 = 0; n0 < H; n0 += NC) {
    gemm_pass<MT, VEC, false>(h1, SH, H, p.w[2], H, n0, ring, acc);
    if (n0 + 32 * warp < H) {
      bias_tanh<MT>(acc, p.w[3], H, n0);
      logit_update<MT>(acc, p.w[4], H, n0, lg);
    }
  }
  // The warps' partial logits, summed in warp order; bias; mask.
  float* part = ring;  // [WARPS, M, HEAD_PAD]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hn = 0; hn < HEAD_TILES; ++hn)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[(warp * M + 16 * mt + g + 8 * (i >> 1)) * HEAD_PAD + 8 * hn + 2 * t + (i & 1)] =
            lg[mt][hn][i];
  __syncthreads();
  for (int i = tid; i < rows * ACT; i += THREADS) {
    const int r = i / ACT, c = i - r * ACT;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += part[(w * M + r) * HEAD_PAD + c];
    s += __ldg(p.w[5] + c);
    const size_t o = (size_t)row0 * ACT + i;
    logits[o] = mask[o] || !any_legal[r] ? s : BIG_NEG;
  }
  if (value == nullptr) return;
  __syncthreads();  // the partials are read before the critic refills the ring

  // Critic: the same two layers, then the one-column value head.
  float v[MT][2] = {};
  hidden1<MT, VEC>(xs, exact, p.w[6], p.w[7], H, h1, SH, ring);
  for (int n0 = 0; n0 < H; n0 += NC) {
    gemm_pass<MT, VEC, false>(h1, SH, H, p.w[8], H, n0, ring, acc);
    if (n0 + 32 * warp < H) {
      bias_tanh<MT>(acc, p.w[9], H, n0);
      value_update<MT>(acc, p.w[10], H, n0, v);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      v[mt][j] += __shfl_xor_sync(0xffffffffu, v[mt][j], 1);
      v[mt][j] += __shfl_xor_sync(0xffffffffu, v[mt][j], 2);
    }
  float* vpart = ring;  // [WARPS, M]
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) vpart[warp * M + 16 * mt + g + 8 * j] = v[mt][j];
  }
  __syncthreads();
  if (tid < rows) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += vpart[w * M + tid];
    value[row0 + tid] = s + __ldg(p.w[11]);
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

template <int MT, bool VEC>
int launch(const void* obs, const void* mask, int B, int H, const Params& p, void* logits,
           void* value, cudaStream_t stream) {
  // Once per kernel: allow the shared memory of the widest hidden layer.
  static const cudaError_t attr =
      cudaFuncSetAttribute(fused_ac_kernel<MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<MT>(MAX_HIDDEN));
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (B + 16 * MT - 1) / (16 * MT);
  fused_ac_kernel<MT, VEC><<<blocks, THREADS, smem_bytes<MT>(H), stream>>>(
      (const int32_t*)obs, (const uint8_t*)mask, B, H, p, (float*)logits, (float*)value);
  return (int)cudaGetLastError();
}

}  // namespace

// obs int32 [B, 297], mask uint8 [B, 45], weights as listed in Params;
// writes logits f32 [B, 45] and, unless `value` is null, value f32 [B].
// The row tile is 16 where that takes no more waves of blocks over the SMs
// than 32 (each block of 16 is shorter), else 32.
extern "C" int fused_actor_critic_forward(const void* obs, const void* mask, int B, int H,
                                          const void* const* weights, void* logits, void* value,
                                          void* stream) {
  if (B <= 0) return 0;
  if (H < 1 || H > MAX_HIDDEN) return (int)cudaErrorInvalidValue;
#ifdef PROBE_ROWS
  const bool rows16 = PROBE_ROWS == 16;
#else
  const int waves16 = ((B + 15) / 16 + sm_count() - 1) / sm_count();
  const int waves32 = ((B + 31) / 32 + sm_count() - 1) / sm_count();
  const bool rows16 = waves16 <= waves32;
#endif
  Params p;
  bool vec = H % 4 == 0;
  for (int i = 0; i < 12; ++i) {
    p.w[i] = (const float*)weights[i];
    if (i == 0 || i == 2 || i == 6 || i == 8) vec = vec && (uintptr_t)p.w[i] % 16 == 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (rows16)
    return vec ? launch<1, true>(obs, mask, B, H, p, logits, value, s)
               : launch<1, false>(obs, mask, B, H, p, logits, value, s);
  return vec ? launch<2, true>(obs, mask, B, H, p, logits, value, s)
             : launch<2, false>(obs, mask, B, H, p, logits, value, s);
}

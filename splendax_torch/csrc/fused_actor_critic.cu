// Fused masked actor-critic forward, f32 on the CUDA cores.
//
// Replaces the TPU kernel `splendax/ops/fused_actor_critic.py` (`_kernel`,
// `fused_masked_forward`): the int32 -> f32 observation cast, the actor MLP
// 297 -> H -> H -> 45 and the critic MLP 297 -> H -> H -> 1 with tanh after
// the first two layers of each, and the masked-logits select (illegal ->
// -1e9; a row with no legal action stays unmasked).
//
// Bound on Hopper: operations.  At the rollout's shapes (B = 8192, H = 768)
// the six products are 2 * B * (2*297*H + 2*H*H + 46*H) = 27 GFLOP against
// 12 MB of obs, mask and outputs and 6.7 MB of weights, far above the f32
// ridge point.  The weights do not fit in one block's 227 KB of shared
// memory, where the TPU kernel kept them all in VMEM.  So each block takes
// TB = 16 rows: it reads their obs and mask once, keeps the x tile and both
// hidden layers in shared
// memory (16 * (297 + 2H) * 4 B = 150 KB at H = 1024), and streams each
// weight matrix from global memory one k-row at a time.  All weights fit in
// the 50 MB L2, so the blocks share them there.  Each thread owns up to 4
// output columns for all 16 rows (64 accumulators in registers): one
// coalesced weight load feeds 16 FMAs, and the x or hidden value for a row
// is one shared-memory broadcast.  Only the masked logits and the value are
// written back.  Plain f32 FMA (no TF32, no tensor cores) keeps the kernel
// within 1e-5 of the plain PyTorch version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OBS = 297;
constexpr int ACT = 45;
constexpr int TB = 16;        // rows per block
constexpr int THREADS = 256;  // 8 warps
constexpr int CMAX = 4;       // columns per thread: H <= THREADS * CMAX
constexpr float BIG_NEG = -1e9f;

// out[b * N + j] = f(bias[j] + sum_k in[b * K + k] * W[k * N + j]) for all
// TB rows b and the C columns j = tid + c * THREADS (< N) this thread owns.
template <int C>
__device__ __forceinline__ void dense(const float* in, int K, const float* __restrict__ W,
                                      const float* __restrict__ bias, int N, float* out,
                                      bool act) {
  const int tid = threadIdx.x;
  if (tid >= N) return;
  float acc[C][TB];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = tid + c * THREADS;
    const float bj = j < N ? __ldg(bias + j) : 0.f;
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[c][b] = bj;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float w[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = tid + c * THREADS;
      w[c] = j < N ? __ldg(W + (size_t)k * N + j) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float x = in[b * K + k];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c][b] = fmaf(x, w[c], acc[c][b]);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = tid + c * THREADS;
    if (j < N) {
#pragma unroll
      for (int b = 0; b < TB; ++b) out[b * N + j] = act ? tanhf(acc[c][b]) : acc[c][b];
    }
  }
}

__device__ __forceinline__ void dense_any(const float* in, int K, const float* W,
                                          const float* bias, int N, float* out, bool act) {
  switch ((N + THREADS - 1) / THREADS) {
    case 1: dense<1>(in, K, W, bias, N, out, act); break;
    case 2: dense<2>(in, K, W, bias, N, out, act); break;
    case 3: dense<3>(in, K, W, bias, N, out, act); break;
    default: dense<4>(in, K, W, bias, N, out, act); break;
  }
}

struct Params {
  const float* w[12];  // aw0 ab0 aw1 ab1 aw2 ab2 cw0 cb0 cw1 cb1 cw2 cb2, [in, out]
};

__global__ void __launch_bounds__(THREADS)
fused_ac_kernel(const int32_t* __restrict__ obs, const uint8_t* __restrict__ mask, int B,
                int H, Params p, float* __restrict__ logits, float* __restrict__ value) {
  extern __shared__ float smem[];
  float* xs = smem;             // [TB, OBS]
  float* h1 = xs + TB * OBS;    // [TB, H]
  float* h2 = h1 + TB * H;      // [TB, H]
  __shared__ int any_legal[TB];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TB;
  const int rows = min(TB, B - row0);

  // The tile's obs rows are contiguous; rows past B read as zeros.
  for (int i = tid; i < TB * OBS; i += THREADS)
    xs[i] = i < rows * OBS ? (float)obs[(size_t)row0 * OBS + i] : 0.f;
  if (tid < TB) {
    int any = 0;
    if (tid < rows)
      for (int j = 0; j < ACT; ++j) any |= mask[(size_t)(row0 + tid) * ACT + j];
    any_legal[tid] = any;
  }
  __syncthreads();

  dense_any(xs, OBS, p.w[0], p.w[1], H, h1, true);
  __syncthreads();
  dense_any(h1, H, p.w[2], p.w[3], H, h2, true);
  __syncthreads();
  dense_any(h2, H, p.w[4], p.w[5], ACT, h1, false);  // raw logits -> h1
  __syncthreads();
  for (int i = tid; i < rows * ACT; i += THREADS) {
    const size_t g = (size_t)row0 * ACT + i;
    logits[g] = (mask[g] || !any_legal[i / ACT]) ? h1[i] : BIG_NEG;
  }
  if (value == nullptr) return;
  __syncthreads();

  dense_any(xs, OBS, p.w[6], p.w[7], H, h1, true);
  __syncthreads();
  dense_any(h1, H, p.w[8], p.w[9], H, h2, true);
  __syncthreads();
  // Value head (one output): a warp per row, lanes striding k.
  const int warp = tid / 32, lane = tid % 32;
  for (int b = warp; b < rows; b += THREADS / 32) {
    float s = 0.f;
    for (int k = lane; k < H; k += 32) s = fmaf(h2[b * H + k], __ldg(p.w[10] + k), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) value[row0 + b] = s + __ldg(p.w[11]);
  }
}

}  // namespace

extern "C" size_t fused_actor_critic_smem_bytes(int H) {
  return sizeof(float) * (size_t)TB * (OBS + 2 * (size_t)H);
}

// obs int32 [B, 297], mask uint8 [B, 45], weights as listed in Params;
// writes logits f32 [B, 45] and, unless `value` is null, value f32 [B].
extern "C" int fused_actor_critic_forward(const void* obs, const void* mask, int B, int H,
                                          const void* const* weights, void* logits,
                                          void* value, void* stream) {
  if (B <= 0) return 0;
  if (H < 1 || H > THREADS * CMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = fused_actor_critic_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p;
  for (int i = 0; i < 12; ++i) p.w[i] = (const float*)weights[i];
  const int blocks = (B + TB - 1) / TB;
  fused_ac_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)obs, (const uint8_t*)mask, B, H, p, (float*)logits, (float*)value);
  return (int)cudaGetLastError();
}

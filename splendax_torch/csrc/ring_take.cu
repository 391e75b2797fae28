// Ring row take: rows[i] = packed[ptr + min(rank[i], window - 1)].
//
// Replaces the TPU kernel `splendax/ops/ring_take.py:38` (`_kernel`,
// `slab_take_rows`), the fresh-game take of the ring (`env/ring.py:take`).
//
// Bound on Hopper: bytes.  It moves B x 135 int8 bytes in and out plus the B
// ranks; there is no arithmetic to speak of.  At the rollout's B = 8192 that
// is 2.3 MB, 0.7 us at 3.35 TB/s, so the time is the latency of a few
// dependent memory accesses, and the design keeps their chain short and the
// bytes per thread many.  Each thread writes 16 contiguous output bytes with
// one 16-byte store: it reads `ptr` and the rank of the (at most two) rows
// those bytes belong to, then loads the 16 source bytes, all independent.
// Row width is a template constant and offsets are 32-bit, so the row and
// column of a byte cost a multiply and a shift.  The TPU kernel staged a slab
// of rows in VMEM and selected them with a one-hot matmul; a slab in shared
// memory costs a block-wide barrier and a second round trip, and was slower
// here.  The ring's `ptr` is read from device memory, so the host never waits
// for it; the mirrored tail of `packed` (its first `window` rows repeated
// after the ring) makes the wrap implicit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WIDTH = 135;

template <int W>
__global__ void __launch_bounds__(THREADS)
ring_take_kernel(const int8_t* __restrict__ packed, const int64_t* __restrict__ ptr,
                 const int64_t* __restrict__ rank, int B, int window,
                 int8_t* __restrict__ rows) {
  const int out_bytes = B * W;
  const int o = 16 * (blockIdx.x * THREADS + threadIdx.x);
  if (o >= out_bytes) return;
  const int r = o / W, c = o - r * W;
  const int64_t base = __ldg(ptr);
  auto source = [&](int row) {
    const int64_t k = __ldg(rank + row);
    return (int)(base + (k < window - 1 ? k : window - 1)) * W;
  };
  const int s0 = source(r);
  const int s1 = c + 16 > W && r + 1 < B ? source(r + 1) - W : s0;  // row r + 1, shifted by W
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (o + j < out_bytes) {
      const int8_t v = __ldg(packed + (c + j < W ? s0 : s1) + c + j);
      word[j / 4] |= (uint32_t)(uint8_t)v << (8 * (j % 4));
    }
  }
  if (o + 16 <= out_bytes) {
    *reinterpret_cast<uint4*>(rows + o) = make_uint4(word[0], word[1], word[2], word[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (o + j < out_bytes) rows[o + j] = (int8_t)(word[j / 4] >> (8 * (j % 4)));
  }
}

}  // namespace

// packed int8 [R, width], ptr int64 scalar, rank int64 [B]; writes rows
// int8 [B, width], which must be 16-byte aligned.  Only width 135 is built;
// B x 135 and the rows of packed must stay below 2^31 bytes.
extern "C" int ring_take_rows(const void* packed, const void* ptr, const void* rank, int B,
                              int width, int window, void* rows, void* stream) {
  if (B <= 0) return 0;
  if (width != WIDTH || (uintptr_t)rows % 16 != 0) return (int)cudaErrorInvalidValue;
  const int threads_needed = (B * WIDTH + 15) / 16;
  ring_take_kernel<WIDTH><<<(threads_needed + THREADS - 1) / THREADS, THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const int8_t*)packed, (const int64_t*)ptr, (const int64_t*)rank, B, window, (int8_t*)rows);
  return (int)cudaGetLastError();
}

// Ring row take: rows[i] = packed[ptr + min(rank[i], window - 1)].
//
// Replaces the TPU kernel `splendax/ops/ring_take.py` (`_kernel`,
// `slab_take_rows`), the fresh-game take of the ring (`env/ring.py:take`).
//
// Bound on Hopper: bytes.  It moves B * 135 int8 bytes in and out plus the
// B ranks; there is no arithmetic to speak of.  The TPU kernel sliced one
// VMEM slab per 128 lanes and selected rows with a one-hot matmul; here each
// thread copies one byte, so neighbouring threads read neighbouring bytes of
// a row (and, since done lanes take consecutive rows, of consecutive rows)
// and write neighbouring output bytes: every warp's load and store is
// coalesced.  The ring's `ptr` is read from device memory, so the host never
// waits for it.  The mirrored tail of `packed` (its first `window` rows
// repeated after the ring) makes the wrap implicit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void ring_take_kernel(const int8_t* __restrict__ packed,
                                 const int64_t* __restrict__ ptr,
                                 const int64_t* __restrict__ rank,
                                 int64_t n_bytes, int width, int64_t window,
                                 int8_t* __restrict__ rows) {
  const int64_t base = *ptr;
  for (int64_t f = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; f < n_bytes;
       f += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = f / width;
    const int64_t c = f - i * width;
    int64_t r = rank[i];
    r = r < window - 1 ? r : window - 1;
    rows[f] = packed[(base + r) * width + c];
  }
}

}  // namespace

extern "C" int ring_take_rows(const void* packed, const void* ptr, const void* rank,
                              int64_t B, int width, int64_t window, void* rows,
                              void* stream) {
  const int64_t n_bytes = B * width;
  if (n_bytes == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n_bytes + threads - 1) / threads;
  if (blocks > 65535 * 8) blocks = 65535 * 8;
  ring_take_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)packed, (const int64_t*)ptr, (const int64_t*)rank, n_bytes, width,
      window, (int8_t*)rows);
  return (int)cudaGetLastError();
}

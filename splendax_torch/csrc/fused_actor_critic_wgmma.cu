// Fused masked actor-critic forward on Hopper's wgmma and TMA, at f32 accuracy.
//
// Replaces the TPU kernel `splendax/ops/fused_actor_critic.py:37` (`_kernel`,
// `fused_masked_forward`, `:60`) at every hidden width: the int32 -> f32
// observation cast, the actor MLP 297 -> H -> H -> 45 and the critic MLP
// 297 -> H -> H -> 1 with tanh after the first two layers of each, and the
// masked-logits select (illegal -> -1e9; a row with no legal action stays
// unmasked).  Up to H = 768 in the tile and cluster modes below; wider nets,
// with no bound on H, in the wide route at the end of this file.
//
// Bound on an H100 SXM: operations.  At B = 8192, H = 768 with the critic the
// six products are 2 B (2·297 H + 2 H² + 46 H) = 27.4 GFLOP; taken as three
// TF32 products each (two for layer 1, whose obs are exact in TF32) that is
// 0.151 ms on the TF32 tensor cores (494.7 TFLOP/s dense).  Weights, obs,
// mask and outputs are 20 MB, 0.006 ms at 3.35 TB/s.  Each 64-row tile
// streams all the split weights (13.4 MB at H = 768) from L2, so a call
// reads (B / 64) x 13.4 MB of L2; at 48 TF32 FLOP for each byte streamed the
// L2 rate, not the tensor cores, is the likely limit.  At small B the bound
// is bytes, and what a tile's blocks take is the latency of their weight
// stream: that is what the cluster mode below is for.
//
// Numerics (3xTF32), as in `fused_actor_critic.cu`: each f32 operand a is
// split into hi = tf32(a) (cvt.rna) and lo = tf32(a - hi), and a·b is taken
// as lo·hi + hi·lo + hi·hi.  Every operand the tensor cores read is an exact
// TF32 value, rounded by cvt.rna beforehand: the weights by `prepare_kernel`
// (once per weight version where the caller holds a prepared handle, else
// once a call), the activations in registers.  A chunk of CHUNK k-steps
// of 8 is summed by `wgmma` from zero into a scratch accumulator, and each
// chunk's sum is added to the f32 accumulator on the CUDA cores, rounded to
// nearest: chained over all of K, the tensor cores' own accumulation drifts
// past the 1e-5 contract.  Layer 1 skips lo·hi in a tile whose obs are all
// exact in TF32 (|x| <= 2048): that product is then exactly zero.  Every sum
// runs in a fixed order per row, so a row's outputs do not depend on B, on
// the other rows of its tile, or on the mode.
//
// Weights.  `prepare_kernel` writes, for aw0, aw1, cw0 and cw1 ([in, out]),
// hi and lo as [2][HP][KP]: output-major, K contiguous (wgmma takes TF32
// from shared memory K-major only), K and N zero-padded to multiples of 8
// (TMA needs 16-byte row strides; 297 x 4 bytes is not one), the second
// layer's K to a multiple of 16.  One 3-D tensor
// map a matrix loads a stage, {8 k} x {NC outputs} x {hi, lo}, with 32-byte
// swizzle, the layout the wgmma descriptors name.
//
// Block.  64 rows (one warpgroup's M), CONSUMERS warpgroups and a producer
// warpgroup, which gives its registers to the consumers (setmaxnreg: 40 a
// thread against 232).  The producer's one thread walks the k-steps in the
// order the consumers take them and keeps a ring of stages full by TMA, each
// stage's `full` mbarrier counting its bytes; every consumer warp arrives on
// the stage's `empty` mbarrier once its products have read it.  A pass
// computes NC = 64 x CONSUMERS output columns, 64 for each consumer group:
// `wgmma.m64n64k8` with A (the activations, split) from registers and B
// (hi, lo) from the ring.  A chunk of two k-steps is one fence, six products
// and one commit group, waited for at once: the probe's one- and
// three-product times fit a fixed cost of some 400 clocks a fence (with A
// in registers the fence waits for the products before it), so fewer,
// larger groups win; a chunk of more k-steps
// would hold more of the ring than H = 768 leaves in tile mode.  Two sets of
// A registers alternate, the next chunk's fragments split while this chunk
// runs (the hardware reads a wgmma's A registers while it runs, so a set is
// rewritten only after the chunk that read it is done).  The first hidden
// layer lives in shared memory in f32 (row stride = 4 mod 8 floats: a warp's
// A-fragment loads hit 32 banks).  Layer 1's A comes from the obs in global
// memory, int32 -> f32 in registers, prefetched two k-steps ahead.  The
// second hidden layer is never stored: bias and tanh in registers, then the
// heads.  A wgmma m64nN accumulator holds, in each group of 8 columns, the
// pairs of an mma.sync m16n8 accumulator over the warp's 16 rows, so it is
// the A operand of an m16n8k8 head product as it stands (with k index j < 4
// at column 2j and j + 4 at 2j + 1): the logits take 3xTF32 mma.sync, the
// value f32 FMAs, and a row's head sums stay in the warp that owns the row.
//
// Heads.  A consumer group's partial head over one pass's 64 columns starts
// from zero: the logits a chain of 3xTF32 mma.sync over its eight groups of
// 8 columns, the value an f32 FMA chain over the thread's 16 columns, then
// summed over the quad's 4 threads (xor 1, then xor 2).  The partials of the
// passes are added in pass order from zero, each consumer group's apart;
// then the two groups' sums are added, then the bias.  Both modes compute
// exactly these sums in this order.
//
// Modes.  Tile mode: a block per 64-row tile takes both heads and every
// pass, with the whole first hidden layer in its own shared memory (197,632
// bytes at H = 768, which leaves four 8 KB stages; this budget is the reason
// for the H <= 768 route).  At small B that is few blocks, each taking every
// pass in turn.  Cluster mode: a block per (64-row tile, pass, head); the
// ceil(H / 128) blocks of one tile and head form a cluster (6 at H = 768,
// within the portable 8), and each streams 1 / passes of one head's weights.
// A block computes its pass's 128 columns of layer 1 into its h1, which has
// tile mode's layout, and sends them to every other block of the cluster by
// bulk copies through distributed shared memory (cp.async.bulk
// shared::cluster, one a row, counted in bytes on the receiver's mbarrier
// for that sender); it computes the same pass's columns of layer 2 from its
// own h1 in tile mode's k order, each pass's k-steps once that pass's
// columns have come in, then its partial head.  The cluster's blocks then
// add the partials (ld.shared::cluster), each block a share of the outputs.
// The mbarriers of each block order the steps: one a sender, by bytes, for
// its columns; and, counting one arrival from every block of the cluster,
// every block has all the columns (so no copy still reads this block's h1,
// which then takes the partials), every partial is written, every block is
// done reading the others' partials (no block exits before).  Two other
// exchanges ran slower on an H100: layer 2 reading its A from the other
// blocks' shared memory a fragment at a time, and h1 stored pass-major (one
// 32 KB copy a receiver, but XOR-swizzled addresses in layer 2's loop).  The
// wrapper picks the mode from B (`fused_actor_critic.wgmma_mode`); the bits
// are the same in both.
//
// The critic alone.  A call without logits computes head 1 only, for
// callers that would drop the logits (a search's leaves, the bootstrap):
// tile mode's producer and consumers walk the head range [1, 2), cluster
// mode and the wide route launch one head on the grid's z, and no mask is
// read.  The critic's passes are those of the call with both heads, in the
// same order from the same zeros, so its value has the same bits.
//
// Wide route (H > 768, any H).  Tile and cluster mode keep a tile's whole
// first hidden layer in one block (64 x H x 4 bytes: 262,144 at H = 1024,
// past the 232,448 a block may hold), so wider nets keep it in device memory
// instead, and no block's shared memory grows with H.  Three launches a forward, in
// stream order, so each reads what the one before wrote with no fence or
// barrier across blocks: layer 1, a block per (pass, 128-row tile, head),
// stores its pass's columns of h1 in f32 to a scratch; layer 2, a block per
// (pass, tile, head), streams the tile's h1 back by TMA ({8 k, 128 rows}
// boxes, 32-byte swizzle) through its ring beside the pass's weights (12 KB
// stages, 16 of them), splits it in registers and writes each 64-column
// group's partial head, from zero, to a second scratch; the third adds the
// partials in pass order as the modes do, so a row's bits are those of the
// emulated order at every width.  Each consumer group takes 64 rows and all
// 128 columns of the pass (wgmma.m64n128k8), so a 128-row block streams
// each weight stage for twice the rows of a tile-mode block and takes twice
// the products per fence.  At H = 1024 with the critic a 128-row tile
// streams ~33 MB of L2 (weights 2 x 10.9 MB, its h1 twice 4.2 MB, its obs
// twice 1.2 MB), 8 passes x 2 heads = 16 blocks a layer.  Bound at H = 1024,
// B = 8192 with the critic: operations, 125.3 GFLOP of TF32 products (two
// for each f32 one of layer 1, three elsewhere), 0.2535 ms at 494.7 TFLOP/s.
// Against the earlier mma.sync kernel, which took these widths up to 1024:
// the weights are split once by the prep kernel, not by every 16- or 32-row
// block in registers; a block streams 1 / passes of one head's
// weights, so B = 1024 gives 128 blocks a layer with the critic, not 32-64;
// and the products are wgmma, not mma.sync.  The wrapper
// cuts B into launches of at most 32,768 rows (`WIDE_MAX_ROWS`), which caps
// the scratch; a row's outputs do not depend on the cut.  Half mode: where
// a block per pass would leave half the SMs idle (`wide_mode`: at most 66
// blocks a layer, e.g. H = 1024, B = 1024 without the critic), a block
// takes 64 columns (BN = 64, wgmma.m64n64k8, 8 KB stages in layer 2): twice
// the blocks, each streaming half the weights and all of its tile's h1, in
// the same sums, so the bits are those of pass mode (BN = 128).
//
// Probe switches.  scripts/torch_kernel_a_probe.py builds variants of this
// file with -D to see where the time goes; the library is built with none.
// PROBE_NO_LOADS never copies a weight stage (wrong numbers: the compute
// alone); PROBE_ONE_PRODUCT takes one TF32 product for each f32 one (wrong
// numbers: a third of the tensor work); PROBE_NO_OBS takes layer 1's A as
// ones instead of loading the obs (wrong numbers: layer 1 without its
// loads); PROBE_CLOCKS writes, in place of the
// logits, each cluster-mode block's %globaltimer at 12 points of its work
// (the probe reads them; needs B >= 64).  PROBE_SMEM_EXTRA=<bytes> asks for
// that much more shared memory in cluster mode, past the card's limit: the
// launch is refused (tests/test_torch_cuda.py holds the wrapper to raising).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int OBS = 297;
constexpr int ACT = 45;
constexpr int HEAD_TILES = 6;  // 45 logits padded to 48: six n-tiles of 8
constexpr int HEAD_PAD = 8 * HEAD_TILES;
constexpr int K1P = 304;       // OBS padded to a multiple of 8
constexpr int M = 64;          // rows per block: one warpgroup's M
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int MAX_STAGES = 16;   // the ring's stages at most
constexpr int CHUNK = 2;  // k-steps of 8 summed on the tensor cores before each f32 add
constexpr int WG_N = 64;                  // output columns per consumer group and pass
constexpr int NC = WG_N * CONSUMERS;      // output columns per pass
constexpr int CONSUMER_THREADS = 128 * CONSUMERS;
constexpr int THREADS = CONSUMER_THREADS + 128;  // plus the producer warpgroup
constexpr int PRODUCER_REGS = 40;                // setmaxnreg: the producer gives up
constexpr int CONSUMER_REGS = 232;               // registers to the consumers
constexpr int KSTEP = 8;
constexpr int STAGE_BYTES = 2 * NC * KSTEP * 4;  // hi and lo, NC outputs x 8 k
// The wide route: a block of WM rows and BN columns, each consumer group
// 64 of the rows and all BN columns: BN = NC (a pass) or WG_N (half a
// pass, where blocks of a pass would leave SMs idle).  A stage holds the BN columns' hi and lo of a k-step
// and, in layer 2, its A: WM rows x 8 k of h1.
constexpr int WM = M * CONSUMERS;
__host__ __device__ constexpr int wide_weight_bytes(int BN) { return 2 * BN * KSTEP * 4; }
__host__ __device__ constexpr int wide_stage_bytes(int BN, int layer) {
  return wide_weight_bytes(BN) + (layer == 2 ? WM * KSTEP * 4 : 0);
}
constexpr int WIDE_SHIFT = 4;  // the wide route's ring: 16 stages
constexpr int OUT_ROWS = 8, OUT_THREADS = 128;  // the wide route's output blocks
constexpr int SMEM_MAX = 232448;
constexpr int ALIGN = 256;                // 32-byte swizzle atoms repeat every 256 bytes
constexpr int MAX_HIDDEN = 768;
constexpr int MAX_GROUPS = 8;             // a cluster's blocks: the portable limit
constexpr float BIG_NEG = -1e9f;
constexpr float TF32_EXACT = 2048.f;      // integers up to this magnitude are exact in TF32
// The cluster mode's barriers: every block has all the columns of h1,
// every partial head is written, every block is done reading the others'
// partials; and, by bytes, the columns of the block of rank r have come in
// (COLUMNS_IN + r).
enum { ALL_IN, PARTIALS_WRITTEN, READS_DONE, COLUMNS_IN, CLUSTER_BARS = COLUMNS_IN + MAX_GROUPS };

static_assert(K1P % (KSTEP * CHUNK) == 0, "layer 1's K comes in whole chunks");
static_assert((MAX_HIDDEN + NC - 1) / NC <= MAX_GROUPS, "the cluster stays portable");

__host__ __device__ constexpr int pad8(int x) { return (x + 7) / 8 * 8; }
// The second layer's K: H padded to a multiple of 16, so that its k-steps
// (and layer 1's 38) come in whole chunks of two.
__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }
// Row stride of the first hidden layer in floats: = 4 mod 8.
__host__ __device__ constexpr int hidden_stride(int H) { return pad16(H) + 4; }
// Floats of the hidden tile, which at the end of the actor holds the
// consumer groups' partial logits.
__host__ __device__ constexpr int hidden_floats(int H) {
  return M * (hidden_stride(H) > HEAD_PAD * CONSUMERS ? hidden_stride(H) : HEAD_PAD * CONSUMERS);
}
// Shared memory after the ring: h1, value partials, the ring's full and
// empty barriers and the cluster mode's, any-legal flags.
__host__ __device__ constexpr int tail_bytes(int H) {
  return hidden_floats(H) * 4 + CONSUMERS * M * 4 + (2 * MAX_STAGES + CLUSTER_BARS) * 8 + M * 4;
}
// log2 of the ring's stages at hidden width H: the most that fit, rounded
// down to a power of two, so that a k-step's stage and phase are bit fields.
constexpr int stage_shift(int H) {
  const int s = (SMEM_MAX - ALIGN - tail_bytes(H)) / STAGE_BYTES;
  int shift = 0;
  while ((2 << shift) <= s && (2 << shift) <= MAX_STAGES) ++shift;
  return shift;
}
static_assert((1 << stage_shift(MAX_HIDDEN)) >= CHUNK, "the ring holds a chunk at H = 768");

struct Params {
  const float* w[12];  // aw0 ab0 aw1 ab1 aw2 ab2 cw0 cb0 cw1 cb1 cw2 cb2, [in, out]
  const int32_t* obs;
  const uint8_t* mask;
  float* logits;
  float* value;  // null: actor only
  int B, H, shift;  // the ring has 1 << shift stages
  int groups;       // cluster mode: the cluster's blocks, one pass each; 0 in tile mode
  int head0, heads;  // the heads computed: 0 the actor, 1 the critic (1, 1: the critic alone)
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of `bar` with this parity to complete.  The loop
// lives in the asm, so the compiler sees no divergent branch around the
// wgmma that follow.  A wait of more than 2^32 clocks (about 2 s) traps, so
// that a broken pipeline ends the launch with an error instead of hanging
// the card.
#define KA_MBAR_WAIT(TRY_WAIT)                          \
  asm volatile(                                         \
      "{\n .reg .pred p;\n .reg .u64 t0, t1;\n"         \
      " mov.u64 t0, %%clock64;\n"                       \
      "WAIT:\n"                                         \
      " " TRY_WAIT " p, [%0], %1;\n"                    \
      " @p bra.uni DONE;\n"                             \
      " mov.u64 t1, %%clock64;\n"                       \
      " sub.u64 t1, t1, t0;\n"                          \
      " setp.gt.u64 p, t1, 4294967296;\n"               \
      " @p trap;\n"                                     \
      " bra.uni WAIT;\n"                                \
      "DONE:\n}" ::"r"(bar),                            \
      "r"(parity)                                       \
      : "memory")

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  KA_MBAR_WAIT("mbarrier.try_wait.parity.shared::cta.b64");
}

// The same wait with acquire at cluster scope: the arrivals came from the
// cluster's blocks, releasing their writes to their own shared memory.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  KA_MBAR_WAIT("mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// dst <- the box of `map` at (k, n, z): a weight map's {8 k, NC outputs, hi
// and lo} at z = 0, or the wide route's h1 map's {8 k, WM rows} of head z.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k, int n,
                                         uint32_t bar, int z = 0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n), "r"(z), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The address in the cluster's shared window of `addr` (a shared address of
// this block) in the block of rank `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// dst (in the cluster's shared window) <- bytes of this block's shared
// memory at src, by the async proxy; the bytes count on the barrier at
// `bar` (in the cluster's window, beside dst).
__device__ __forceinline__ void copy_to(uint32_t dst, uint32_t src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One arrival on the barrier at `bar` (a shared address of this block) in
// the block of rank `rank`, releasing this thread's writes to the cluster.
__device__ __forceinline__ void arrive_in(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
                   mapa(bar, rank))
               : "memory");
}

#ifdef PROBE_CLOCKS
// Stamp i of a cluster-mode block: %globaltimer (ns) when thread 0 passes
// it; the block's 12 stamps go to the logits in place of its outputs.
#define KA_STAMP(t, i) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t[i])::"memory")
#else
#define KA_STAMP(t, i)
#endif

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins registers in place relative to the wgmma fences and waits around it:
// without it the compiler may compute an A fragment after the fence, or read
// a scratch accumulator before its wait, and ptxas then serialises the wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a K-major operand tile with 32-byte swizzle: 8 k (32 bytes)
// per row, 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(256 >> 4) << 32) |
         ((uint64_t)3 << 62);
}

#define KA_D32(c)                                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]),   \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),          \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),          \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define KA_WGMMA_N64                                                                           \
  "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                                             \
  " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "         \
  "{%32, %33, %34, %35}, %36, p, 1, 1;\n}"

// d = a b + (ACC ? d : 0): a 64x8 TF32 from registers, b 8x64 TF32
// K-major in shared memory, d 64x64 f32.  ACC = 0 takes d as outputs only,
// so that its old value is dead to the compiler.
template <int ACC>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (ACC) {
    asm volatile(KA_WGMMA_N64
                 : KA_D32("+f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(KA_WGMMA_N64
                 : KA_D32("=f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
}

#define KA_D64(c) c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]), c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define KA_WGMMA_N128                                                                          \
  "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"                                             \
  " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                                                                       \
  "{%64, %65, %66, %67}, %68, p, 1, 1;\n}"

// The same with n = 128 (the wide route: a consumer group takes every
// column of the pass), d 64x128 f32.
template <int ACC>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (ACC) {
    asm volatile(KA_WGMMA_N128
                 : KA_D64("+f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(KA_WGMMA_N128
                 : KA_D64("=f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
}

// The wgmma of the accumulator's width: F = 32 floats a thread is n = 64,
// F = 64 is n = 128.
template <int ACC, int F>
__device__ __forceinline__ void product(float (&d)[F], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (F == 64) wgmma_n128<ACC>(d, a, b); else wgmma_n64<ACC>(d, a, b);
}

// m16n8k8 mma.sync: d += a b, and d = a b.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d += a b for one head k-step at f32 accuracy (lo·hi + hi·lo + hi·hi from
// zero on the tensor cores, then one f32 add).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
#ifdef PROBE_ONE_PRODUCT
  mma(d, ah, bh0, bh1);
#else
  float s[4];
  mma0(s, al, bh0, bh1);
  mma(s, ah, bl0, bl1);
  mma(s, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
#endif
}

// ---------------------------------------------------------------- the block

struct Smem {
  uint32_t ring;   // shared address of stage 0
  const unsigned char* ring_p;  // the same, as a generic pointer
  float* h1;       // [M, SH] first hidden layer; partial logits at the end of the actor
  float* vpart;    // [CONSUMERS, M] value partials
  uint32_t full;   // shared address of full[0]; empty[s] is full + 8 (MAX_STAGES + s), the
                   // cluster mode's barrier i full + 8 (2 MAX_STAGES + i)
  int* any_legal;  // [M]
  int shift;  // the ring has 1 << shift stages
};

__device__ __forceinline__ uint32_t full_bar(const Smem& s, int st) { return s.full + 8 * st; }
__device__ __forceinline__ uint32_t empty_bar(const Smem& s, int st) {
  return s.full + 8 * (MAX_STAGES + st);
}
__device__ __forceinline__ uint32_t cluster_bar(const Smem& s, int i) {
  return s.full + 8 * (2 * MAX_STAGES + i);
}

// Where the consumer thread sits: group c, warp wl of the group, lane = 4 g + t.
struct Lane {
  int c, wl, g, t;
};

// The four obs of this thread's layer-1 A fragment at k-step j: rows
// 16 wl + g (+ 8), columns 8 j + t (+ 4); zeros past the rows and past OBS.
__device__ __forceinline__ void obs_frag(const int32_t* __restrict__ x, int rows, const Lane& l,
                                         int j, int (&v)[4]) {
  const int r0 = 16 * l.wl + l.g, k0 = KSTEP * j + l.t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 8 * (i & 1), k = k0 + 4 * (i >> 1);
#ifdef PROBE_NO_OBS
    v[i] = r < rows && k < OBS;
#else
    // A clamped address and a select: no branch among the wgmma.
    const int got = __ldg(x + (size_t)min(r, rows - 1) * OBS + min(k, OBS - 1));
    v[i] = r < rows && k < OBS ? got : 0;
#endif
  }
}

// This thread's A fragment of k-step j (rows 16 l.wl + g and + 8 of the
// block), split: for layer 1 (L1) from the obs prefetched in pa (pa <- pb <-
// the obs of k-step j + 2); for the wide route's layer 2 (BN > 0, a block of
// BN columns) from the A box of the k-step's stage, once it is full; else
// from h1.
template <bool L1, bool EXACT, int BN>
__device__ __forceinline__ void load_a(const Smem& sm, uint32_t it0, const Lane& l, int j,
                                       const float* h1, int SH, const int32_t* __restrict__ x,
                                       int rows, int (&pa)[4], int (&pb)[4], uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  if constexpr (BN > 0 && !L1) {
    const uint32_t it = it0 + j;
    const int st = it & ((1 << sm.shift) - 1);
#ifndef PROBE_NO_LOADS
    mbar_wait(full_bar(sm, st), (it >> sm.shift) & 1);
#endif
    // [WM rows][8 k] with 32-byte swizzle: the 16-byte half of row r that
    // holds k < 4 is half (r >> 2) & 1.
    const float* a = reinterpret_cast<const float*>(sm.ring_p + st * wide_stage_bytes(BN, 2) +
                                                    wide_weight_bytes(BN));
    const int r = 16 * l.wl + l.g, k0 = 4 * ((r >> 2) & 1) + l.t, k4 = k0 ^ 4;
    const float av[4] = {a[8 * r + k0], a[8 * (r + 8) + k0], a[8 * r + k4], a[8 * (r + 8) + k4]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(av[i], ah[i], al[i]);
  } else if constexpr (L1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = (float)pa[i];
      if constexpr (EXACT) {
        ah[i] = __float_as_uint(a);
        al[i] = 0u;
      } else {
        split(a, ah[i], al[i]);
      }
      pa[i] = pb[i];
    }
    obs_frag(x, rows, l, j + 2, pb);
  } else {
    const float* a = h1 + (16 * l.wl + l.g) * SH + KSTEP * j + l.t;
    const float av[4] = {a[0], a[8 * SH], a[4], a[8 * SH + 4]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(av[i], ah[i], al[i]);
  }
}

// This warp is done with the stage of k-step j: its lane 0 arrives, by a
// predicate inside the asm (a branch on the lane would put the wgmma on a
// divergent path).
__device__ __forceinline__ void release_kstep(const Smem& sm, uint32_t it0, int j) {
#ifndef PROBE_NO_LOADS
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}" ::"r"(
          empty_bar(sm, (it0 + j) & ((1 << sm.shift) - 1))),
      "r"(threadIdx.x & 31)
      : "memory");
#endif
}

template <int N>
__device__ __forceinline__ void add_acc(float (&acc)[N], float (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += s[i];
}

// Issue chunk j / CHUNK of a pass into the scratch accumulator s, from
// zero: a wait for its stages, one fence, then for each k-step lo·hi
// (unless A is exact), hi·lo and hi·hi, and one commit.  ah / al hold the
// chunk's A fragments, loaded before.
// BN > 0: the wide route's products over all BN columns of its stages
// (n = BN); else this group's 64 columns of the pass.
template <bool L1, bool EXACT, int BN>
__device__ __forceinline__ void issue_chunk(const Smem& sm, const Lane& l, uint32_t it0, int j,
                                            uint32_t (&ah)[CHUNK][4], uint32_t (&al)[CHUNK][4],
                                            float (&s)[BN == NC ? 64 : 32]) {
  constexpr int SB = BN > 0 ? wide_stage_bytes(BN, L1 ? 1 : 2) : STAGE_BYTES;
  constexpr int SN = BN > 0 ? BN : NC;  // the stage's columns
  uint64_t dh[CHUNK], dl[CHUNK];
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) {
    const uint32_t it = it0 + j + q;
    const int st = it & ((1 << sm.shift) - 1);
#ifndef PROBE_NO_LOADS
    mbar_wait(full_bar(sm, st), (it >> sm.shift) & 1);
#endif
    const uint32_t bh = sm.ring + st * SB + (BN > 0 ? 0 : l.c * WG_N * KSTEP * 4);
    dh[q] = desc_sw32(bh);
    dl[q] = desc_sw32(bh + SN * KSTEP * 4);
  }
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) {
#ifdef PROBE_ONE_PRODUCT
    (void)dl;
    if (q == 0) product<0>(s, ah[q], dh[q]); else product<1>(s, ah[q], dh[q]);
#else
    if constexpr (L1 && EXACT) {
      if (q == 0) product<0>(s, ah[q], dl[q]); else product<1>(s, ah[q], dl[q]);
    } else {
      if (q == 0) product<0>(s, al[q], dh[q]); else product<1>(s, al[q], dh[q]);
      product<1>(s, ah[q], dl[q]);
    }
    product<1>(s, ah[q], dh[q]);
#endif
  }
  wgmma_commit();
  fence_regs(s);
}

// The A fragments of the chunk at k-step j, pinned in their registers.
template <bool L1, bool EXACT, int BN>
__device__ __forceinline__ void load_chunk(const Smem& sm, uint32_t it0, const Lane& l, int j,
                                           const float* h1, int SH, const int32_t* __restrict__ x,
                                           int rows, int (&pa)[4], int (&pb)[4],
                                           uint32_t (&ah)[CHUNK][4], uint32_t (&al)[CHUNK][4]) {
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) {
    load_a<L1, EXACT, BN>(sm, it0, l, j + q, h1, SH, x, rows, pa, pb, ah[q], al[q]);
    fence_regs(ah[q]);
    fence_regs(al[q]);
  }
}

// The end of a chunk: wait for its products, release its stages, add its
// sum to acc in f32.
template <int N>
__device__ __forceinline__ void finish_chunk(const Smem& sm, uint32_t it0, int j,
                                             float (&acc)[N], float (&s)[N]) {
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) release_kstep(sm, it0, j + q);
  add_acc(acc, s);
}

// acc += A W[:, this group's 64 columns of the pass] over k-steps j0 ... j1
// - 1 of the pass (j1 - j0 a multiple of CHUNK), the ring's k-steps it0 + j,
// a chunk of CHUNK k-steps at a time.  Each chunk is one fence and one commit group,
// summed on the tensor cores from zero and added to acc once it is done;
// the wait for it is the only one, so the chunk's products run back to
// back.  The hardware reads a wgmma's A registers while it runs, so the two
// sets of A registers alternate: the next chunk's fragments are loaded
// while this chunk runs, into the set the chunk before read.  BN > 0: the
// wide route's block of WM rows and BN columns, this group's 64 of the rows
// and all BN columns (n = BN), A from the obs (L1) or the ring's stages;
// else this group's 64 columns of the block's 64 rows, A from the obs (L1)
// or h1.
template <bool L1, bool EXACT, int BN = 0>
__device__ __forceinline__ void gemm_pass(const Smem& sm, const Lane& l, uint32_t it0, int j0,
                                          int j1, const float* h1, int SH,
                                          const int32_t* __restrict__ x, int rows,
                                          float (&acc)[BN == NC ? 64 : 32]) {
  constexpr int N = BN == NC ? 64 : 32;
  // The lane of the A fragments: in the wide route group c's rows are 64 c
  // + 16 wl + g (+ 8).
  const Lane la = BN > 0 ? Lane{l.c, 4 * l.c + l.wl, l.g, l.t} : l;
  float s[N];
  int pa[4], pb[4];
  uint32_t ah0[CHUNK][4], al0[CHUNK][4], ah1[CHUNK][4], al1[CHUNK][4];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = 0.f;
  if constexpr (L1) {
    obs_frag(x, rows, la, j0, pa);
    obs_frag(x, rows, la, j0 + 1, pb);
  }
  load_chunk<L1, EXACT, BN>(sm, it0, la, j0, h1, SH, x, rows, pa, pb, ah0, al0);
  for (int j = j0;; j += 2 * CHUNK) {
    issue_chunk<L1, EXACT, BN>(sm, l, it0, j, ah0, al0, s);
    if (j + CHUNK < j1)
      load_chunk<L1, EXACT, BN>(sm, it0, la, j + CHUNK, h1, SH, x, rows, pa, pb, ah1, al1);
    finish_chunk(sm, it0, j, acc, s);
    if (j + CHUNK == j1) return;
    issue_chunk<L1, EXACT, BN>(sm, l, it0, j + CHUNK, ah1, al1, s);
    if (j + 2 * CHUNK < j1)
      load_chunk<L1, EXACT, BN>(sm, it0, la, j + 2 * CHUNK, h1, SH, x, rows, pa, pb, ah0, al0);
    finish_chunk(sm, it0, j + CHUNK, acc, s);
    if (j + 2 * CHUNK == j1) return;
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// Layer 1 of one pass: acc = x W0[:, this group's columns], whichever
// products the tile's obs need.
__device__ __forceinline__ void layer1_pass(const Smem& sm, const Lane& l, uint32_t it0,
                                            const int32_t* __restrict__ x, int rows, bool exact,
                                            float (&acc)[32]) {
  zero_acc(acc);
  if (exact)
    gemm_pass<true, true>(sm, l, it0, 0, K1P / KSTEP, nullptr, 0, x, rows, acc);
  else
    gemm_pass<true, false>(sm, l, it0, 0, K1P / KSTEP, nullptr, 0, x, rows, acc);
}

// Column of accumulator element (i, e) of n8 group i: 8 i + 2 t + e within the group's 64.
__device__ __forceinline__ int acc_col(const Lane& l, int n0, int i, int e) {
  return n0 + WG_N * l.c + 8 * i + 2 * l.t + e;
}

// acc <- tanh(acc + bias); columns at or past H come out 0.
__device__ __forceinline__ void bias_tanh(const Lane& l, float (&acc)[32],
                                          const float* __restrict__ bias, int H, int n0) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = acc_col(l, n0, i, e);
      const float b = col < H ? __ldg(bias + col) : 0.f;
      acc[4 * i + e] = tanhf(acc[4 * i + e] + b);
      acc[4 * i + 2 + e] = tanhf(acc[4 * i + 2 + e] + b);
    }
}


// h1[r, col] <- acc for this thread's columns col of the pass at n0 below pad16(H).
__device__ __forceinline__ void store_h1(const Lane& l, const float (&acc)[32], float* h1, int H,
                                         int n0) {
  const int r0 = 16 * l.wl + l.g, SH = hidden_stride(H);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = acc_col(l, n0, i, 0);
    if (col >= pad16(H)) continue;
    *reinterpret_cast<float2*>(h1 + r0 * SH + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(h1 + (r0 + 8) * SH + col) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// The partial logits of this thread's rows into [CONSUMERS, M, HEAD_PAD] at part.
__device__ __forceinline__ void store_logits(const Lane& l, const float (&lg)[HEAD_TILES][4],
                                             float* part) {
  const int r0 = 16 * l.wl + l.g;
#pragma unroll
  for (int hn = 0; hn < HEAD_TILES; ++hn)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part[(l.c * M + r0 + 8 * (i >> 1)) * HEAD_PAD + 8 * hn + 2 * l.t + (i & 1)] = lg[hn][i];
}

// out = h2 W2[this group's columns of the pass, 0:45] for the warp's 16
// rows, a chain from zero over the group's eight column groups of 8.
__device__ __forceinline__ void logit_partial(const Lane& l, const float (&h2)[32],
                                              const float* __restrict__ W2, int H, int n0,
                                              float (&out)[HEAD_TILES][4]) {
#pragma unroll
  for (int hn = 0; hn < HEAD_TILES; ++hn)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[hn][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t ah[4], al[4];
    const float av[4] = {h2[4 * i], h2[4 * i + 2], h2[4 * i + 1], h2[4 * i + 3]};
#pragma unroll
    for (int q = 0; q < 4; ++q) split(av[q], ah[q], al[q]);
    const int r0 = acc_col(l, n0, i, 0), r1 = r0 + 1;
#pragma unroll
    for (int hn = 0; hn < HEAD_TILES; ++hn) {
      const int n = 8 * hn + l.g;
      uint32_t bh0, bl0, bh1, bl1;
#ifdef PROBE_NO_W2
      split(r0 < H && n < ACT ? 0.01f * n : 0.f, bh0, bl0);
      split(r1 < H && n < ACT ? 0.02f * n : 0.f, bh1, bl1);
#else
      split(r0 < H && n < ACT ? __ldg(W2 + r0 * ACT + n) : 0.f, bh0, bl0);
      split(r1 < H && n < ACT ? __ldg(W2 + r1 * ACT + n) : 0.f, bh1, bl1);
#endif
      mma3(out[hn], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// out = h2 wv over this group's columns of the pass for rows g and g + 8 of
// the warp: an f32 FMA chain from zero over the thread's 16 columns, then the
// sum over the quad's 4 threads, which all hold it.
__device__ __forceinline__ void value_partial(const Lane& l, const float (&h2)[32],
                                              const float* __restrict__ wv, int H, int n0,
                                              float (&out)[2]) {
  out[0] = out[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = acc_col(l, n0, i, e);
      const float w = col < H ? __ldg(wv + col) : 0.f;
      out[0] = fmaf(h2[4 * i + e], w, out[0]);
      out[1] = fmaf(h2[4 * i + 2 + e], w, out[1]);
    }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    out[j] += __shfl_xor_sync(0xffffffffu, out[j], 1);
    out[j] += __shfl_xor_sync(0xffffffffu, out[j], 2);
  }
}

// Tile mode: heads head0 ... head0 + heads - 1 in turn, a pass at a time.
__device__ __forceinline__ void consume(const Smem& sm, const Params& p,
                                        const int32_t* __restrict__ x, int rows, int row0,
                                        bool exact, int head0, int heads) {
  const int tid = threadIdx.x, H = p.H, SH = hidden_stride(H);
  const Lane l{tid >> 7, (tid >> 5) & 3, (tid & 31) >> 2, tid & 3};
  const int passes = (H + NC - 1) / NC, nk1 = K1P / KSTEP, nk2 = pad16(H) / KSTEP;
  float acc[32];
  uint32_t it = 0;
  const int r0 = 16 * l.wl + l.g;  // this thread's rows r0 and r0 + 8 of the tile

  for (int head = head0; head < head0 + heads; ++head) {
    const float* const* w = p.w + 6 * head;
    // Layer 1: h1 = tanh(x W0 + b0), all columns, into shared memory.
    for (int q = 0; q < passes; ++q, it += nk1) {
      layer1_pass(sm, l, it, x, rows, exact, acc);
      bias_tanh(l, acc, w[1], H, NC * q);
      store_h1(l, acc, sm.h1, H, NC * q);
    }
    consumer_sync();  // h1 is whole
    // Layer 2 a pass at a time, straight into the heads: each pass's
    // partial added to the running sums in pass order.
    float lg[HEAD_TILES][4] = {}, v[2] = {0.f, 0.f};
    for (int q = 0; q < passes; ++q, it += nk2) {
      zero_acc(acc);
      gemm_pass<false, false>(sm, l, it, 0, nk2, sm.h1, SH, x, rows, acc);
      bias_tanh(l, acc, w[3], H, NC * q);
      if (head == 0) {
        float pl[HEAD_TILES][4];
        logit_partial(l, acc, w[4], H, NC * q, pl);
#pragma unroll
        for (int hn = 0; hn < HEAD_TILES; ++hn)
#pragma unroll
          for (int i = 0; i < 4; ++i) lg[hn][i] += pl[hn][i];
      } else {
        float pv[2];
        value_partial(l, acc, w[4], H, NC * q, pv);
        v[0] += pv[0];
        v[1] += pv[1];
      }
    }
    consumer_sync();  // every read of h1 is done: its space takes the partial heads
    if (head == 0) {
      const float* part = sm.h1;
      store_logits(l, lg, sm.h1);
      consumer_sync();
      for (int i = tid; i < rows * ACT; i += CONSUMER_THREADS) {
        const int r = i / ACT, col = i - r * ACT;
        const float s =
            part[r * HEAD_PAD + col] + part[(M + r) * HEAD_PAD + col] + __ldg(w[5] + col);
        const size_t o = (size_t)row0 * ACT + i;
        p.logits[o] = p.mask[o] || !sm.any_legal[r] ? s : BIG_NEG;
      }
      consumer_sync();  // the partials are read before the critic writes h1
    } else {
      if (l.t == 0) {
        sm.vpart[l.c * M + r0] = v[0];
        sm.vpart[l.c * M + r0 + 8] = v[1];
      }
      consumer_sync();
      if (tid < rows) {
        p.value[row0 + tid] = sm.vpart[tid] + sm.vpart[M + tid] + __ldg(w[5]);
      }
    }
  }
}

// Cluster mode: the consumers are done with step i; once all have passed
// their barrier, lane q of the first warp arrives on barrier i of block q,
// for every block of the cluster (this one's too), all at once.
__device__ __forceinline__ void publish(const Smem& sm, int i, int groups) {
  consumer_sync();
  if (threadIdx.x < groups) arrive_in(cluster_bar(sm, i), threadIdx.x);
}


// Bytes of a row of h1 in the pass of the block of rank r: its columns
// below pad16(H), which it sends to every other block of its cluster.
__device__ __forceinline__ int pass_bytes(int H, int r) {
  return 4 * (min(NC * (r + 1), pad16(H)) - NC * r);
}

// Cluster mode: this block's head and pass (its rank in the cluster).
// Layer 1's columns of the pass into h1, then sent to every other block of
// the cluster by bulk copies, one a row; layer 2's columns of the pass over
// the whole of h1, as in tile mode, each pass's k-steps once its columns
// have come in; its partial head into h1's space once no copy reads h1 any
// more; once every partial is written, this block's share of the outputs,
// the partials of the passes in pass order.
__device__ __forceinline__ void consume_cluster(const Smem& sm, const Params& p,
                                                const int32_t* __restrict__ x, int rows,
                                                int row0, bool exact, int head, int rank,
                                                uint64_t* clk) {
  const int tid = threadIdx.x, H = p.H, P = p.groups, n0 = NC * rank, SH = hidden_stride(H);
  const Lane l{tid >> 7, (tid >> 5) & 3, (tid & 31) >> 2, tid & 3};
  const float* const* w = p.w + 6 * head;
  const int r0 = 16 * l.wl + l.g;
  float acc[32];
  layer1_pass(sm, l, 0, x, rows, exact, acc);
  bias_tanh(l, acc, w[1], H, n0);
  store_h1(l, acc, sm.h1, H, n0);
  KA_STAMP(clk, 4);
  // The copies read h1 through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumer_sync();
  for (int i = tid; i < M * (P - 1); i += CONSUMER_THREADS) {
    const int r = i % M, d = i / M, to = d + (d >= rank);
    const uint32_t src = smem_u32(sm.h1 + r * SH + n0);
    copy_to(mapa(src, to), src, pass_bytes(H, rank), mapa(cluster_bar(sm, COLUMNS_IN + rank), to));
  }
  KA_STAMP(clk, 5);
  // Layer 2 in the k order of tile mode, each pass's k-steps once its
  // columns are in: the copies still coming overlap the products.
  zero_acc(acc);
  constexpr int STEPS = NC / KSTEP;
  for (int r = 0; r < P; ++r) {
    mbar_wait_cluster(cluster_bar(sm, COLUMNS_IN + r), 0);
    gemm_pass<false, false>(sm, l, K1P / KSTEP, STEPS * r, min(STEPS * (r + 1), pad16(H) / KSTEP),
                            sm.h1, SH, x, rows, acc);
  }
  if (tid < P) arrive_in(cluster_bar(sm, ALL_IN), tid);
  KA_STAMP(clk, 6);
  bias_tanh(l, acc, w[3], H, n0);
  KA_STAMP(clk, 12);
  float pl[HEAD_TILES][4], pv[2];
  if (head == 0)
    logit_partial(l, acc, w[4], H, n0, pl);
  else
    value_partial(l, acc, w[4], H, n0, pv);
  KA_STAMP(clk, 10);
  mbar_wait_cluster(cluster_bar(sm, ALL_IN), 0);  // no copy reads this block's h1 any more
  consumer_sync();                                // nor does layer 2
  KA_STAMP(clk, 11);
  float* part = sm.h1;  // [CONSUMERS, M, HEAD_PAD] logits, or [CONSUMERS, M] value
  if (head == 0) {
    store_logits(l, pl, part);
  } else if (l.t == 0) {
    part[l.c * M + r0] = pv[0];
    part[l.c * M + r0 + 8] = pv[1];
  }
  publish(sm, PARTIALS_WRITTEN, P);
  mbar_wait_cluster(cluster_bar(sm, PARTIALS_WRITTEN), 0);
  KA_STAMP(clk, 7);
  const uint32_t base = smem_u32(part);
  if (head == 0) {
    for (int i = rank * CONSUMER_THREADS + tid; i < rows * ACT; i += P * CONSUMER_THREADS) {
      const int r = i / ACT, col = i - r * ACT;
      float s0 = 0.f, s1 = 0.f;
      for (int q = 0; q < P; ++q) {
        const uint32_t a = mapa(base + 4 * (r * HEAD_PAD + col), q);
        s0 += ld_cluster(a);
        s1 += ld_cluster(a + 4 * M * HEAD_PAD);
      }
      const float s = s0 + s1 + __ldg(w[5] + col);
      const size_t o = (size_t)row0 * ACT + i;
#ifndef PROBE_CLOCKS
      p.logits[o] = p.mask[o] || !sm.any_legal[r] ? s : BIG_NEG;
#endif
    }
  } else {
    for (int r = rank * CONSUMER_THREADS + tid; r < rows; r += P * CONSUMER_THREADS) {
      float s0 = 0.f, s1 = 0.f;
      for (int q = 0; q < P; ++q) {
        const uint32_t a = mapa(base + 4 * r, q);
        s0 += ld_cluster(a);
        s1 += ld_cluster(a + 4 * M);
      }
      p.value[row0 + r] = s0 + s1 + __ldg(w[5]);
    }
  }
  KA_STAMP(clk, 8);
  publish(sm, READS_DONE, P);
  mbar_wait_cluster(cluster_bar(sm, READS_DONE), 0);  // no other block reads this one now
#ifdef PROBE_CLOCKS
  KA_STAMP(clk, 9);
  if (tid == 0) {
    const size_t b = blockIdx.x + (size_t)gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    for (int i = 0; i < 13; ++i) reinterpret_cast<uint64_t*>(p.logits)[13 * b + i] = clk[i];
  }
#endif
}

// CL: cluster mode (grid: tiles x groups x heads, a cluster over the
// groups), else tile mode (grid: tiles).
template <bool CL>
__global__ void __launch_bounds__(THREADS, 1)
fused_ac_wgmma_kernel(const __grid_constant__ CUtensorMap map_a0,
                      const __grid_constant__ CUtensorMap map_a1,
                      const __grid_constant__ CUtensorMap map_c0,
                      const __grid_constant__ CUtensorMap map_c1, const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.H;
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) / ALIGN * ALIGN;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  Smem sm;
  const int stages = 1 << p.shift;
  sm.shift = p.shift;
  sm.ring = base;
  sm.ring_p = gbase;
  sm.h1 = reinterpret_cast<float*>(gbase + stages * STAGE_BYTES);
  sm.vpart = sm.h1 + hidden_floats(H);
  unsigned char* bars = reinterpret_cast<unsigned char*>(sm.vpart + CONSUMERS * M);
  sm.full = smem_u32(bars);
  sm.any_legal = reinterpret_cast<int*>(bars + (2 * MAX_STAGES + CLUSTER_BARS) * 8);

  const int tid = threadIdx.x, row0 = blockIdx.x * M, rows = min(M, p.B - row0);
  const int32_t* x = p.obs + (size_t)row0 * OBS;
  // The heads and passes this block streams: all of the call's in tile
  // mode, one each in cluster mode.
  int head0 = p.head0, heads = p.heads, q0 = 0, nq = (H + NC - 1) / NC;
  if constexpr (CL) {
    head0 = p.head0 + blockIdx.z;
    heads = 1;
    q0 = cluster_rank();
    nq = 1;
  }
  uint64_t clk[13];
  KA_STAMP(clk, 0);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar(sm, s), 1);
      mbar_init(empty_bar(sm, s), CONSUMER_THREADS / 32);
    }
    if constexpr (CL) {
      for (int i = ALL_IN; i < COLUMNS_IN; ++i) mbar_init(cluster_bar(sm, i), p.groups);
      for (int r = 0; r < p.groups; ++r) {
        mbar_init(cluster_bar(sm, COLUMNS_IN + r), 1);
        mbar_expect_tx(cluster_bar(sm, COLUMNS_IN + r), r == q0 ? 0 : M * pass_bytes(H, r));
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int big = 0;
  for (int i = tid; i < rows * OBS; i += THREADS) big |= fabsf((float)__ldg(x + i)) > TF32_EXACT;
  if (tid < M) {  // the critic alone reads no mask
    int any = 0;
    if (tid < rows && p.head0 == 0)
      for (int j = 0; j < ACT; ++j) any |= p.mask[(size_t)(row0 + tid) * ACT + j];
    sm.any_legal[tid] = any;
  }
  const bool exact = !__syncthreads_or(big);
  KA_STAMP(clk, 1);
  if constexpr (CL) {
    cluster_sync();  // every block's barriers are set before another arrives on them
    KA_STAMP(clk, 2);
  }

  // The warpgroup's role, warp-uniform as the compiler sees it (through a
  // shuffle), so that the consumers' wgmma sit on no divergent path.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
#ifndef PROBE_NO_LOADS
    if (tid == CONSUMER_THREADS) {
      // The producer's thread: every stage of the block's passes, in the consumers' order.
      const int nk2 = pad16(H) / KSTEP, mask = stages - 1;
      uint32_t it = 0;
      for (int head = head0; head < head0 + heads; ++head)
        for (int layer = 0; layer < 2; ++layer) {
          const CUtensorMap* map = head == 0 ? (layer == 0 ? &map_a0 : &map_a1)
                                             : (layer == 0 ? &map_c0 : &map_c1);
          const int nk = layer == 0 ? K1P / KSTEP : nk2;
          for (int q = q0; q < q0 + nq; ++q)
            for (int j = 0; j < nk; ++j, ++it) {
              const int st = it & mask;
              mbar_wait(empty_bar(sm, st), ((it >> p.shift) & 1) ^ 1);
              mbar_expect_tx(full_bar(sm, st), STAGE_BYTES);
              tma_load(sm.ring + st * STAGE_BYTES, map, KSTEP * j, NC * q, full_bar(sm, st));
            }
        }
      // Stay until the consumers have released every stage.
      for (int q = 0; q < stages && q < (int)it; ++q, ++it)
        mbar_wait(empty_bar(sm, it & mask), ((it >> p.shift) & 1) ^ 1);
    }
#endif
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    KA_STAMP(clk, 3);
    if constexpr (CL)
      consume_cluster(sm, p, x, rows, row0, exact, head0, q0, clk);
    else
      consume(sm, p, x, rows, row0, exact, head0, heads);
  }
}


// ------------------------------------------------------------ the wide route

// The wide route's launches: scratch in device memory, [heads][B][pad16(H)]
// h1 (a plane a head computed), then, with the actor,
// [passes][CONSUMERS][B][HEAD_PAD] partial logits and, with the critic,
// [passes][CONSUMERS][B] partial values.
struct WideParams {
  const float* w[12];  // as in Params
  const int32_t* obs;
  const uint8_t* mask;
  float* logits;
  float* value;  // null: actor only
  float* h1;
  float* lpart;
  float* vpart;
  int B, H;
  int head0;  // the first head computed (grid z adds to it): 1 runs the critic alone
};

// Column group CG's 32 floats of a wide accumulator: its columns 64 CG
// ... 64 CG + 63 of the block, laid out as an n = 64 accumulator's.
template <int CG, int F>
__device__ __forceinline__ float (&group_acc(float (&acc)[F]))[32] {
  return *reinterpret_cast<float(*)[32]>(acc + 32 * CG);
}

// The lane that addresses a 64-column group (acc_col, bias_tanh, the heads)
// for this thread's rows, given the group's first column as n0.
__device__ __forceinline__ Lane group_lane(const Lane& l) { return {0, l.wl, l.g, l.t}; }

// h1 rows 64 c + 16 wl + g (+ 8) of the tile, columns 64 g ... 64 g + 63 of
// the hidden layer below pad16(H), from a, to the scratch.
__device__ __forceinline__ void wide_store_h1(const Lane& l, const float (&a)[32], float* h1,
                                              int KH, int rows, int g) {
  const int r0 = 64 * l.c + 16 * l.wl + l.g;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = acc_col(group_lane(l), WG_N * g, i, 0);
    if (col >= KH) continue;
    if (r0 < rows)
      *reinterpret_cast<float2*>(h1 + (size_t)r0 * KH + col) = make_float2(a[4 * i], a[4 * i + 1]);
    if (r0 + 8 < rows)
      *reinterpret_cast<float2*>(h1 + (size_t)(r0 + 8) * KH + col) =
          make_float2(a[4 * i + 2], a[4 * i + 3]);
  }
}

// Column group CG of a layer-1 block's accumulator: bias, tanh, to the scratch.
template <int CG, int F>
__device__ __forceinline__ void wide_h1_group(const Lane& l, float (&acc)[F], const float* bias,
                                              float* h1, int H, int rows, int g) {
  bias_tanh(group_lane(l), group_acc<CG>(acc), bias, H, WG_N * g);
  wide_store_h1(l, group_acc<CG>(acc), h1, pad16(H), rows, g);
}

// Layer 1 of a block of BN columns (block column b): those columns of h1
// for the tile's WM rows, bias and tanh, stored to the scratch in f32 (its
// h1 plane `plane`).
template <int BN>
__device__ __forceinline__ void wide_layer1(const Smem& sm, const WideParams& p,
                                            const int32_t* __restrict__ x, int rows, int row0,
                                            bool exact, int head, int plane, int b) {
  const int tid = threadIdx.x, g = BN / WG_N * b;
  const Lane l{tid >> 7, (tid >> 5) & 3, (tid & 31) >> 2, tid & 3};
  float acc[BN == NC ? 64 : 32];
  zero_acc(acc);
  if (exact)
    gemm_pass<true, true, BN>(sm, l, 0, 0, K1P / KSTEP, nullptr, 0, x, rows, acc);
  else
    gemm_pass<true, false, BN>(sm, l, 0, 0, K1P / KSTEP, nullptr, 0, x, rows, acc);
  const float* bias = p.w[6 * head + 1];
  float* h1 = p.h1 + ((size_t)plane * p.B + row0) * pad16(p.H);
  wide_h1_group<0>(l, acc, bias, h1, p.H, rows, g);
  if constexpr (BN == NC) wide_h1_group<1>(l, acc, bias, h1, p.H, rows, g + 1);
}

// Column group CG of a layer-2 block's accumulator (hidden columns 64 g
// ...): bias and tanh, then its partial head over those 64 columns, from
// zero, for this thread's rows, stored to the scratch ([2 passes][B]...).
template <int CG, int F>
__device__ __forceinline__ void wide_head(const Lane& l, const WideParams& p, float (&acc)[F],
                                          const float* const* w, int head, int rows, int row0,
                                          int g) {
  const int r0 = 64 * l.c + 16 * l.wl + l.g, n0 = WG_N * g;
  const size_t part = (size_t)g * p.B + row0;  // the group's first row
  float(&a)[32] = group_acc<CG>(acc);
  bias_tanh(group_lane(l), a, w[3], p.H, n0);
  if (head == 0) {
    float pl[HEAD_TILES][4];
    logit_partial(group_lane(l), a, w[4], p.H, n0, pl);
#pragma unroll
    for (int hn = 0; hn < HEAD_TILES; ++hn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * e;
        if (r < rows)
          *reinterpret_cast<float2*>(p.lpart + (part + r) * HEAD_PAD + 8 * hn + 2 * l.t) =
              make_float2(pl[hn][2 * e], pl[hn][2 * e + 1]);
      }
  } else {
    float pv[2];
    value_partial(group_lane(l), a, w[4], p.H, n0, pv);
    if (l.t == 0) {
      if (r0 < rows) p.vpart[part + r0] = pv[0];
      if (r0 + 8 < rows) p.vpart[part + r0 + 8] = pv[1];
    }
  }
}

// Layer 2 of a block of BN columns (block column b): those columns over all
// of K, A from the ring, in tile mode's k order; then each 64-column
// group's bias, tanh and partial head.
template <int BN>
__device__ __forceinline__ void wide_layer2(const Smem& sm, const WideParams& p, int rows,
                                            int row0, int head, int b) {
  const int tid = threadIdx.x, g = BN / WG_N * b;
  const Lane l{tid >> 7, (tid >> 5) & 3, (tid & 31) >> 2, tid & 3};
  const float* const* w = p.w + 6 * head;
  float acc[BN == NC ? 64 : 32];
  zero_acc(acc);
  gemm_pass<false, false, BN>(sm, l, 0, 0, pad16(p.H) / KSTEP, nullptr, 0, nullptr, rows, acc);
  wide_head<0>(l, p, acc, w, head, rows, row0, g);
  if constexpr (BN == NC) wide_head<1>(l, p, acc, w, head, rows, row0, g + 1);
}

// One layer of the wide route: a block per (BN columns, WM-row tile, head),
// grid (blocks of columns, tiles, heads), so that the blocks running at
// once share a tile's h1 and a head's weights in L2.  The head of grid z is
// head0 + z, its h1 the scratch's plane z.  Layer 1's ring stages
// hold the block's weights of a k-step; layer 2's also the tile's h1 of
// that k-step, from the scratch by TMA.
template <int LAYER, int BN>
__global__ void __launch_bounds__(THREADS, 1)
fused_ac_wide_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_c,
                     const __grid_constant__ CUtensorMap map_h1, const WideParams p) {
  constexpr int SB = wide_stage_bytes(BN, LAYER), STAGES = 1 << WIDE_SHIFT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) / ALIGN * ALIGN;
  Smem sm;
  sm.shift = WIDE_SHIFT;
  sm.ring = base;
  sm.ring_p = smem_raw + (base - smem_u32(smem_raw));
  sm.full = base + STAGES * SB;
  sm.h1 = nullptr;
  sm.vpart = nullptr;
  sm.any_legal = nullptr;
  const int tid = threadIdx.x, b = blockIdx.x, row0 = blockIdx.y * WM;
  const int plane = blockIdx.z, head = p.head0 + plane;
  const int rows = min(WM, p.B - row0);
  const int32_t* x = p.obs + (size_t)row0 * OBS;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(sm, s), 1);
      mbar_init(empty_bar(sm, s), CONSUMER_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int big = 0;
  if constexpr (LAYER == 1)
    for (int i = tid; i < rows * OBS; i += THREADS) big |= fabsf((float)__ldg(x + i)) > TF32_EXACT;
  const bool exact = !__syncthreads_or(big);

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
#ifndef PROBE_NO_LOADS
    if (tid == CONSUMER_THREADS) {
      const CUtensorMap* map = head == 0 ? &map_a : &map_c;
      const int nk = LAYER == 1 ? K1P / KSTEP : pad16(p.H) / KSTEP;
      int it = 0;
      for (; it < nk; ++it) {
        const int st = it & (STAGES - 1);
        mbar_wait(empty_bar(sm, st), ((it >> WIDE_SHIFT) & 1) ^ 1);
        mbar_expect_tx(full_bar(sm, st), SB);
        tma_load(sm.ring + st * SB, map, KSTEP * it, BN * b, full_bar(sm, st));
        if constexpr (LAYER == 2)
          tma_load(sm.ring + st * SB + wide_weight_bytes(BN), &map_h1, KSTEP * it, row0,
                   full_bar(sm, st), plane);
      }
      // Stay until the consumers have released every stage.
      for (int i = 0; i < STAGES && i < nk; ++i, ++it)
        mbar_wait(empty_bar(sm, it & (STAGES - 1)), ((it >> WIDE_SHIFT) & 1) ^ 1);
    }
#endif
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    if constexpr (LAYER == 1)
      wide_layer1<BN>(sm, p, x, rows, row0, exact, head, plane, b);
    else
      wide_layer2<BN>(sm, p, rows, row0, head, b);
  }
}

// The wide route's outputs of OUT_ROWS rows: every pass's partials in pass
// order from zero, each column group's apart, then the two groups' sums,
// then the bias, as the other modes add them; the masked-logits select.
// Small blocks, so that a small B still spreads over the SMs: the partials'
// loads, not their adds, take the time.  The critic alone (null logits)
// reads no mask.
__global__ void __launch_bounds__(OUT_THREADS) wide_heads_kernel(const WideParams p) {
  __shared__ int any_legal[OUT_ROWS];
  const int tid = threadIdx.x, row0 = blockIdx.x * OUT_ROWS, rows = min(OUT_ROWS, p.B - row0);
  const int passes = (p.H + NC - 1) / NC;
  if (tid < OUT_ROWS) {
    int any = 0;
    if (tid < rows && p.logits != nullptr)
      for (int j = 0; j < ACT; ++j) any |= p.mask[(size_t)(row0 + tid) * ACT + j];
    any_legal[tid] = any;
  }
  __syncthreads();
  const size_t group = (size_t)p.B;  // rows between a pass's two consumer groups
  for (int i = tid; p.logits != nullptr && i < rows * ACT; i += blockDim.x) {
    const int r = i / ACT, col = i - r * ACT;
    const float* a = p.lpart + (size_t)(row0 + r) * HEAD_PAD + col;
    float s0 = 0.f, s1 = 0.f;
    for (int q = 0; q < passes; ++q) {
      s0 += a[CONSUMERS * q * group * HEAD_PAD];
      s1 += a[(CONSUMERS * q + 1) * group * HEAD_PAD];
    }
    const float s = s0 + s1 + __ldg(p.w[5] + col);
    const size_t o = (size_t)row0 * ACT + i;
    p.logits[o] = p.mask[o] || !any_legal[r] ? s : BIG_NEG;
  }
  if (p.value != nullptr)
    for (int r = tid; r < rows; r += blockDim.x) {
      const float* a = p.vpart + row0 + r;
      float s0 = 0.f, s1 = 0.f;
      for (int q = 0; q < passes; ++q) {
        s0 += a[CONSUMERS * q * group];
        s1 += a[(CONSUMERS * q + 1) * group];
      }
      p.value[row0 + r] = s0 + s1 + __ldg(p.w[11]);
    }
}

// ---------------------------------------------------------------- weight preparation
//
// The split and transpose of aw0, aw1, cw0, cw1 (each [K_m, H], row-major):
// dst[m] = [2][HP][KP_m] with hi = cvt.rna(w) and lo = cvt.rna(w - hi),
// output-major, zeros past K and H.  The wrapper runs it once per weight
// version (`fused_actor_critic.PreparedWeights`), or once a forward on a
// plain list of weights.
//
// Bound: bytes.  At H = 768 with the critic it reads 6.5 MB and writes
// 13.2 MB, 0.0059 ms at 3.35 TB/s; no arithmetic to speak of.  So the
// design is about bytes in flight and whole sectors.  A block per 64 x 64
// tile of a destination matrix (64 k of 64 outputs), the grid enumerating
// exactly the tiles of the 2 or 4 matrices (no block returns at once);
// 256 threads of 16 KB of shared memory, so eight blocks fit an SM and at
// H <= 1280 every tile is resident at once.  Each thread issues its four
// 16-byte cp.async loads along H before waiting for any (the whole tile,
// 16 KB a block, in flight), straight into shared memory; a warp's loads
// are two rows of 256 contiguous bytes.  Rows of a tile past K, and columns
// past H, are zero-filled by the copy itself (source size 0).  The tile is
// stored [k][64] with its 16-byte chunks XOR-swizzled by bits 2-4 of k, so
// that the transposed reads hit 32 banks: a warp reads 4 outputs x 32 k,
// each thread 4 consecutive k of one output, and writes them as one
// 16-byte store of hi and one of lo, a warp's stores four rows of 128
// contiguous bytes each.  Where H is not a multiple of 4 (or a weight is
// not 16-byte aligned) the loads are 4-byte cp.async into the same layout.
constexpr int PT = 64;              // a tile: PT k x PT outputs
constexpr int PREP_THREADS = 256;
constexpr int PREP_MATS = 4;

struct PrepParams {
  const float* src[PREP_MATS];  // [K_m, H]
  float* dst[PREP_MATS];
  int K[PREP_MATS], KP[PREP_MATS];
  int first[PREP_MATS + 1];     // the first tile of each matrix; first[mats] tiles in all
  int H, HP, mats;
};

// The float offset of tile element (k, n) in shared memory.
__device__ __forceinline__ int prep_at(int k, int n) {
  return k * PT + (((n >> 2) ^ ((k >> 2) & 7)) << 2) + (n & 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(PREP_THREADS) prepare_kernel(const PrepParams p) {
  __shared__ __align__(16) float tile[PT * PT];
  const int b = blockIdx.x;
  int m = 0;
  while (m + 1 < p.mats && b >= p.first[m + 1]) ++m;
  const int K = p.K[m], KP = p.KP[m], k_tiles = (KP + PT - 1) / PT;
  const int r = b - p.first[m], k0 = r % k_tiles * PT, n0 = r / k_tiles * PT;
  const float* src = p.src[m];
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < PT * PT / 4 / PREP_THREADS; ++i) {
      const int c = i * PREP_THREADS + tid, kl = c / (PT / 4), nl = c % (PT / 4) * 4;
      const int k = k0 + kl, n = n0 + nl;
      const bool in = k < K && n < p.H;
      cp_async16(smem_u32(tile + prep_at(kl, nl)), in ? src + (size_t)k * p.H + n : src,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < PT * PT / PREP_THREADS; ++i) {
      const int c = i * PREP_THREADS + tid, kl = c / PT, nl = c % PT;
      const int k = k0 + kl, n = n0 + nl;
      const bool in = k < K && n < p.H;
      cp_async4(smem_u32(tile + prep_at(kl, nl)), in ? src + (size_t)k * p.H + n : src,
                in ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  float* hi = p.dst[m];
  float* lo = hi + (size_t)p.HP * KP;
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < PT * PT / 4 / PREP_THREADS; ++i) {
    // 32 (group of 4 outputs, half of the k) pairs, one a warp at a time.
    const int pair = i * (PREP_THREADS / 32) + warp;
    const int nl = (pair >> 1) * 4 + (lane >> 3), kl = (pair & 1) * (PT / 2) + (lane & 7) * 4;
    const int n = n0 + nl, k = k0 + kl;
    if (n >= p.HP || k >= KP) continue;
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split(tile[prep_at(kl + j, nl)], h[j], l[j]);
    const size_t o = (size_t)n * KP + k;
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// The map of one prepared matrix [2][HP][KP]: boxes of {8 k, n outputs, 2}.
int encode(CUtensorMap* map, const float* base, int HP, int KP, int n = NC) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)KP, (cuuint64_t)HP, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)KP * 4, (cuuint64_t)HP * KP * 4};
  const cuuint32_t box[3] = {KSTEP, (cuuint32_t)n, 2}, estride[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)base, dims, strides, box,
                        estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Floats of the prepared buffer before matrix m (aw0 aw1 cw0 cw1).
size_t prepared_offset(int H, int m) {
  const size_t HP = pad8(H), a = 2 * HP * K1P, b = 2 * HP * pad16(H);
  return (m >> 1) * (a + b) + (m & 1) * a;
}

// The wide route's map of h1 in the scratch, [heads][B][KH]: boxes of {8 k, WM rows, 1}.
int encode_h1(CUtensorMap* map, const float* base, int KH, int B, int heads) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)KH, (cuuint64_t)B, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)KH * 4, (cuuint64_t)B * KH * 4};
  const cuuint32_t box[3] = {KSTEP, WM, 1}, estride[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)base, dims, strides, box,
                        estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Floats of the wide route's scratch for B rows (WideParams), with the
// actor and with the critic.
size_t wide_scratch_floats(int B, int H, bool actor, bool critic) {
  const size_t passes = (H + NC - 1) / NC;
  return (size_t)B * ((actor + critic) * (size_t)pad16(H) +
                      (actor ? passes * CONSUMERS * HEAD_PAD : 0) +
                      (critic ? passes * CONSUMERS : 0));
}

// A wide-route layer's kernel, with its shared memory limit raised once.
template <int LAYER, int BN>
cudaError_t wide_ready() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_ac_wide_kernel<LAYER, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  return attr;
}

// The shared memory of a wide-route layer's block.
constexpr size_t wide_smem(int BN, int layer) {
  return ALIGN + ((size_t)wide_stage_bytes(BN, layer) << WIDE_SHIFT) + 2 * MAX_STAGES * 8;
}

// The two layers of the wide route with blocks of BN columns, in stream order.
template <int BN>
cudaError_t wide_layers(const CUtensorMap (&maps)[4], const CUtensorMap& map_h1,
                        const WideParams& p, int tiles, int heads, cudaStream_t st) {
  cudaError_t e = wide_ready<1, BN>();
  if (e == cudaSuccess) e = wide_ready<2, BN>();
  if (e != cudaSuccess) return e;
  const dim3 grid((p.H + NC - 1) / NC * (NC / BN), tiles, heads);
  size_t smem2 = wide_smem(BN, 2);
#ifdef PROBE_SMEM_EXTRA
  smem2 += PROBE_SMEM_EXTRA;
#endif
  fused_ac_wide_kernel<1, BN><<<grid, THREADS, wide_smem(BN, 1), st>>>(maps[0], maps[2], map_h1, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fused_ac_wide_kernel<2, BN><<<grid, THREADS, smem2, st>>>(maps[1], maps[3], map_h1, p);
  return cudaGetLastError();
}

// The kernel of a mode, with its shared memory limit raised once.
template <bool CL>
cudaError_t kernel_ready() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_ac_wgmma_kernel<CL>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  return attr;
}

size_t smem_bytes(int H) {
  return ALIGN + ((size_t)STAGE_BYTES << stage_shift(H)) + tail_bytes(H);
}

// The cluster mode's launch: tiles x groups x heads blocks, a cluster over the groups.
cudaLaunchConfig_t cluster_config(int tiles, int groups, int heads, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, groups, heads);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = groups;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The split, transposed weights of aw0, aw1 (and, with `critic`, cw0, cw1)
// into `prepared`, laid out as `prepared_offset` says.  One launch.
extern "C" int fused_actor_critic_wgmma_prepare(const void* const* weights, int H, int critic,
                                                void* prepared, void* stream) {
  if (H < 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)prepared % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int src[4] = {0, 2, 6, 8};
  PrepParams p;
  p.H = H;
  p.HP = pad8(H);
  p.mats = critic ? 4 : 2;
  bool vec = H % 4 == 0;
  int tiles = 0;
  for (int m = 0; m < p.mats; ++m) {
    p.src[m] = (const float*)weights[src[m]];
    p.dst[m] = (float*)prepared + prepared_offset(H, m);
    p.K[m] = m & 1 ? H : OBS;
    p.KP[m] = m & 1 ? pad16(H) : K1P;
    p.first[m] = tiles;
    tiles += (p.KP[m] + PT - 1) / PT * ((p.HP + PT - 1) / PT);
    vec = vec && (uintptr_t)p.src[m] % 16 == 0;
  }
  p.first[p.mats] = tiles;
  if (vec)
    prepare_kernel<true><<<tiles, PREP_THREADS, 0, (cudaStream_t)stream>>>(p);
  else
    prepare_kernel<false><<<tiles, PREP_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// obs int32 [B, 297], mask uint8 [B, 45], weights as listed in Params (the
// heads and biases are read from there), `prepared` as the prepare call left
// it; writes logits f32 [B, 45] and, unless `value` is null, value f32 [B].
// Null `logits` runs the critic alone, which reads no mask (it may be null):
// the value's bits are those of the call with both heads.  groups = 0 runs
// tile mode; else cluster mode, with groups = ceil(H / 128) (the blocks of a
// cluster, one pass each).
extern "C" int fused_actor_critic_wgmma_forward(const void* obs, const void* mask, int B, int H,
                                                const void* const* weights, const void* prepared,
                                                void* logits, void* value, int groups,
                                                void* stream) {
  if (B <= 0) return 0;
  if (H < 1 || H > MAX_HIDDEN || (!logits && !value)) return (int)cudaErrorInvalidValue;
  if (groups != 0 && groups != (H + NC - 1) / NC) return (int)cudaErrorInvalidValue;
  const int HP = pad8(H);
  CUtensorMap maps[4];
  for (int m = 0; m < 4; ++m) {
    const int err = encode(&maps[m], (const float*)prepared + prepared_offset(H, m), HP,
                           m & 1 ? pad16(H) : K1P);
    if (err) return err;
  }
  Params p;
  for (int i = 0; i < 12; ++i) p.w[i] = (const float*)weights[i];
  p.obs = (const int32_t*)obs;
  p.mask = (const uint8_t*)mask;
  p.logits = (float*)logits;
  p.value = (float*)value;
  p.B = B;
  p.H = H;
  p.groups = groups;
  p.head0 = logits ? 0 : 1;
  p.heads = (logits ? 1 : 0) + (value ? 1 : 0);
  const bool cl = groups > 0;
  p.shift = stage_shift(H);
  size_t smem = smem_bytes(H);
  const int tiles = (B + M - 1) / M;
  if (!cl) {
    const cudaError_t attr = kernel_ready<false>();
    if (attr != cudaSuccess) return (int)attr;
    fused_ac_wgmma_kernel<false><<<tiles, THREADS, smem, (cudaStream_t)stream>>>(
        maps[0], maps[1], maps[2], maps[3], p);
    return (int)cudaGetLastError();
  }
#ifdef PROBE_SMEM_EXTRA
  smem += PROBE_SMEM_EXTRA;
#endif
  const cudaError_t attr = kernel_ready<true>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      cluster_config(tiles, groups, p.heads, smem, (cudaStream_t)stream, &cluster);
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &p};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, (const void*)fused_ac_wgmma_kernel<true>, args);
  const cudaError_t last = cudaGetLastError();  // cleared: a refused launch is reported once
  return (int)(err != cudaSuccess ? err : last);
}

// The wide route (any H): obs, mask, weights, prepared and outputs as in
// fused_actor_critic_wgmma_forward (null `logits`: the critic alone);
// `scratch` holds at least `scratch_floats` floats, which must be
// wide_scratch_floats(B, H, with the actor, with the critic);
// `columns` is a block's columns, 128 (a pass) or 64 (half a pass).
// Three launches on the stream, in order: layer 1, layer 2 with the
// partial heads, the outputs.  Each reads what the one before wrote, so
// the launch boundaries order the stores of h1 before layer 2's TMA reads
// of it, and no fence or barrier across blocks is needed.
extern "C" int fused_actor_critic_wide_forward(const void* obs, const void* mask, int B, int H,
                                               const void* const* weights, const void* prepared,
                                               void* scratch, long long scratch_floats,
                                               void* logits, void* value, int columns,
                                               void* stream) {
  if (B <= 0) return 0;
  const int heads = (logits ? 1 : 0) + (value ? 1 : 0), KH = pad16(H), tiles = (B + WM - 1) / WM;
  if (H < 1 || heads == 0 || tiles > 65535 || (columns != NC && columns != WG_N))
    return (int)cudaErrorInvalidValue;
  if (scratch_floats < (long long)wide_scratch_floats(B, H, logits != nullptr, value != nullptr))
    return (int)cudaErrorInvalidValue;
  const int HP = pad8(H), passes = (H + NC - 1) / NC;
  CUtensorMap maps[4], map_h1;
  for (int m = 0; m < 4; ++m) {
    const int err = encode(&maps[m], (const float*)prepared + prepared_offset(H, m), HP,
                           m & 1 ? KH : K1P, columns);
    if (err) return err;
  }
  WideParams p;
  for (int i = 0; i < 12; ++i) p.w[i] = (const float*)weights[i];
  p.obs = (const int32_t*)obs;
  p.mask = (const uint8_t*)mask;
  p.logits = (float*)logits;
  p.value = (float*)value;
  p.h1 = (float*)scratch;
  p.lpart = p.h1 + (size_t)heads * B * KH;
  p.vpart = p.lpart + (logits ? (size_t)passes * CONSUMERS * B * HEAD_PAD : 0);
  p.B = B;
  p.H = H;
  p.head0 = logits ? 0 : 1;
  const int err = encode_h1(&map_h1, p.h1, KH, B, heads);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = columns == NC ? wide_layers<NC>(maps, map_h1, p, tiles, heads, st)
                                      : wide_layers<WG_N>(maps, map_h1, p, tiles, heads, st);
  if (e != cudaSuccess) return (int)e;
  wide_heads_kernel<<<(B + OUT_ROWS - 1) / OUT_ROWS, OUT_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// How many clusters of the cluster mode at hidden width H can be resident
// on the card at once, into *count.
extern "C" int fused_actor_critic_wgmma_max_clusters(int H, int* count) {
  if (H < 1 || H > MAX_HIDDEN) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = kernel_ready<true>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      cluster_config(1, (H + NC - 1) / NC, 1, smem_bytes(H), nullptr, &cluster);
  return (int)cudaOccupancyMaxActiveClusters(count, (const void*)fused_ac_wgmma_kernel<true>,
                                             &cfg);
}

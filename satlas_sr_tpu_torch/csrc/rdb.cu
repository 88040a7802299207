// ResidualDenseBlock of the RRDBNet trunk, for Hopper (sm_90a).
//
// Replaces satlas_sr_tpu/ops/pallas/rdb.py:129 rdb_pallas, in both of its
// dtypes (float32 and bfloat16). One RDB is
//   x_{k+1} = lrelu_0.2(conv3x3_k(concat(x, x_1 .. x_k)))   for k = 0..3
//   out     = x + 0.2 * conv3x3_4(concat(x, x_1 .. x_4))
// over NHWC tensors, with nf = 64 feature and g = 32 growth channels at the
// flagship width. Two designs, chosen on the host by shape (ops/cuda/rdb.py
// rdb_route):
//
// A. Five launches over a dense-concat buffer (dense_conv3x3_wgmma for bf16,
//    dense_conv3x3_tf32x3 for f32). They take nf and g of 32 or 64 (the
//    wgmma widths N they are built for); anything else is refused with
//    ERR_SHAPE. The wrapper allocates one channels-last buffer
//    [B, H, W, nf + 4g] and copies x into channels [0, nf). Launch k reads
//    channels [0, nf + k*g) and, for k < 4, writes its g output channels at
//    [nf + k*g, nf + (k+1)*g) of the same buffer, so the concat is never
//    materialised; launch 4 writes x + 0.2*conv to the output tensor.
//
//    Each conv is an implicit GEMM on the tensor cores, M = an 8-row x
//    TW-column output band of one image (8*TW pixels), N = cout (32, or 64
//    for conv5), K = 9 taps x cin, accumulated in f32 by wgmma. One block per
//    band, both dtypes with the same pipeline:
//    - A (pixels x channels) is never copied per tap. A TMA tiled load writes
//      the band with its halo, 10 rows x (TW+2) columns x 32 bytes of
//      channels (16 bf16 or 8 f32: one wgmma k-step), as [channel group]
//      [column][row][16 B]: the tensor map views buf as (16 B of channels,
//      H, W, channel groups, B), innermost first, and its out-of-bounds zero
//      fill, starting at row -1 and column -1, is the conv's zero padding. In
//      that order 8 consecutive M rows (8 rows of one column) are one 8 x
//      16 B core matrix of wgmma's no-swizzle layout: an m64 tile is 8 rows x
//      8 columns, SBO is one column (160 B), LBO one channel-group plane
//      ((TW+2)*160 B), and tap (dy, dx) adds dy*16 + dx*160 bytes, so all
//      nine taps read the same staged band.
//    - B (weights) is packed on the host (ops/cuda/rdb.py pack_weights) into
//      the exact shared-memory image the B descriptor reads and moved by one
//      1-D bulk copy per stage.
//    - A ring of 3 stages of (one k-step of input channels, their weights),
//      filled by one producer warp (TMA + bulk copy, completed on the stage's
//      mbarrier) while two consumer warpgroups run the nine taps' wgmmas; a
//      consumer frees a stage once the wgmma groups that read it have
//      retired. At TW = 32 and 16 each warpgroup owns TW/16 m64 tiles and all
//      N; at TW = 8 (one tile) the two split N.
//    - Epilogue in registers: bias, LeakyReLU (launches 0-3) or 0.2*v + x
//      (launch 4), one rounding to the tensor's type, stored straight into
//      the concat buffer's channel slice or out. The 0.2 is 0.2 in the
//      tensor's type (point_two: 0.2001953125 in bf16), as the JAX block's
//      constants are.
//
//    bfloat16 (dense_conv3x3_wgmma, TW = 32): wgmma.m64nNk16.bf16 with A and
//    B both read through shared-memory descriptors. Two blocks fit on an SM.
//
//    float32 (dense_conv3x3_tf32x3, TW = 32, 16 or 8): f32 accuracy from
//    TF32 tensor cores. The tensor core reads 19 bits of each f32 operand,
//    so one TF32 product loses the f32 result (on an RDB more than 3x the
//    port's f32 tolerance, as tests/test_torch_rdb.py emulates it); each
//    operand is split as hi = tf32(v), lo = tf32(v - hi) and three products
//    hi*hi + lo*hi + hi*lo (lo*lo is below f32's rounding) give f32 accuracy
//    at a third of the 495 TFLOP/s TF32 rate, ~165 TFLOP/s: 2.5x the
//    67 TFLOP/s of plain FP32 FMAs, which is what bounded the direct kernel
//    this replaced. tf32 wgmma takes K-major operands only and is k8 deep.
//    - B: hi and lo are split on the host and stacked along N,
//      [cin/8][9][2][hi N | lo N][4], so B_lo is B_hi's descriptor + N*16 B.
//    - A: the consumers load their register fragment of each tap from the
//      staged band, split it in registers (round to nearest, ties away, to
//      10 mantissa bits: the same bit arithmetic as the host packing) and
//      issue wgmma.m64nNk8.tf32 with A in registers, three per tap and tile
//      into one accumulator: A_hi B_hi + A_lo B_hi + A_hi B_lo. A thread's
//      fragment of tap (dy, dx) is band row lane/4 + dy of columns 2q + dx
//      (+1), so the three dx taps of one dy share four loaded columns: 8
//      loads and splits serve 9 wgmmas. Two register sets alternate between
//      (dy, tile) units, and a set is rewritten only after wgmma.wait_group
//      has retired the group that read it. This keeps up to 122 registers a
//      thread live, so the kernel runs one block per SM (at two, ptxas
//      serialises the wgmmas for want of registers, C7511). The weights'
//      bytes per stage double against bf16 (hi and lo, 4 B each): 3 stages
//      take 88 KB at N = 32, 143 KB at 64.
//    - Band width. One block does one band's whole conv, and a block runs
//      alone on its SM, so when B * ceil(H/8) * ceil(W/TW) is below the 132
//      SMs the time is one block's, not the work's: a 32x32 image at TW = 32
//      is 4 blocks on 4 SMs. The host picks the narrowest TW in {32, 16, 8}
//      whose blocks run in one wave (16 blocks for a 32x32 image at TW = 8),
//      or 32 when none does: two waves of half-width blocks cost more than
//      one of full-width ones, since each block pays the ring's fill. The
//      f32 RDB keeps five launches: a resident f32 concat (twice design B's
//      bytes: 77 KB at TW = 8) does not fit beside the f32 weight stages
//      (143 KB at N = 64) in 227 KB.
//
// B. One launch on a thread-block cluster (rdb_cluster_wgmma, bf16, nf 64,
//    g 32): for small batches of small images, where design A's four 8x32
//    bands an image leave the card idle and its five launches each refill
//    the ring.
//    - One cluster per image; its blocks split the image into 8-row x
//      TW-column bands (TW = 16 or 8: 8 or 16 blocks for 32x32; up to 16
//      blocks, with cudaFuncAttributeNonPortableClusterSizeAllowed).
//    - Each block keeps its band of the whole dense concat on chip for all
//      five convs: (8+2) x (TW+2) pixels x 192 channels in design A's
//      no-swizzle layout ([channel group][column][row][16 B]), 38.4 KB at
//      TW = 8 and 69.1 KB at 16. x is loaded once, by TMA from x itself
//      (its out-of-bounds zero fill is the padding), so the wrapper copies x
//      nowhere; channels 64..191 start zero.
//    - Two consumer warpgroups. At TW = 16 each owns one m64 tile and all N;
//      at TW = 8 (one tile) they take alternate k-steps with all N and pass
//      each other half of their partial sums through shared memory (split
//      across N instead, each wgmma at N = 16 ran at a quarter of the
//      tensor cores' rate).
//    - Conv k's epilogue stores its 32 channels into the block's own
//      buffer; then the consumers copy the band's edge rows and columns of
//      those channels into the neighbours' halo slots over distributed
//      shared memory, one 16-byte channel group a thread
//      (st.shared::cluster.v4). Rows and columns at or past the image's
//      edge are zero on both sides: they stay the next conv's zero padding
//      (the 13- and 18-row bands of the row-sharded paths end mid-band).
//    - An mbarrier a block separates conv k from conv k+1: each block's
//      consumers meet, one thread a block arrives on every block's barrier
//      (release.cluster), and all wait on their own (acquire.cluster),
//      with fence.proxy.async.shared::cta on both sides so that the next
//      conv's wgmma (the async proxy) sees the generic stores; the fence
//      without a state space cost ~1 us a call. The wait is bounded by
//      WAIT_LIMIT like every mbarrier wait here; only the one hardware
//      cluster barrier at the start (before the mbarriers exist) is not.
//      The producer warp stays out of it, so the weights of conv k+1 load
//      while conv k finishes.
//    - The weights stream through each block's own ring, 40 k-steps over
//      the five convs, one bulk copy a stage from L2 (479 KB a block): 4
//      stages ahead of each warpgroup (8 at TW = 8, where each reads every
//      other one).
//      Multicasting each stage to the cluster (.multicast::cluster), which
//      reads each byte from L2 once, ran slower on an H100 at [1, 32, 32, 64]
//      in both forms tried (every block multicasting its 1/n slice; one
//      block multicasting whole stages): a multicast stage is refilled only
//      once every block of the cluster has released it, so the slowest
//      block paces every ring.
//    - Conv 5 writes x + 0.2*x5 to out. With a concat buffer (the training
//      forward keeps it for rdb_backward) it also writes x and x1..x4 there.
//    Bounded by the same math as A (490.7 MFLOP for a 32x32 image, 0.50 us at
//    the bf16 peak) spread over 8-16 SMs; on an H100 an m64 wgmma of these
//    k-steps took ~80 cycles at N = 32 or 64 alike, so a block's main loops
//    (360 wgmmas at TW = 8 over two warpgroups, 720 at 16) take ~8 or
//    ~16 us, and the five barriers, epilogues and set-up ~10 us more
//    (PERF.md section 6).
//
// What still bounds each route, and what a faster one changes: see
// ops/cuda/rdb.py and PERF.md.
//
// Plain C interface, loaded with ctypes: the host functions return
// cudaGetLastError() after each launch (0 on success), or a negative code of
// their own (ssr_cuda_error_string names both). Launches go on the caller's
// stream; nothing here allocates or synchronises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int TH = 8;                                   // output rows per block
constexpr int BAND_ROWS = TH + 2;                       // 10
constexpr int COL_BYTES = BAND_ROWS * 16;               // 160: A's SBO
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;                            // warpgroups
constexpr int WG_THREADS = 128;
constexpr int WGMMA_THREADS = CONSUMERS * WG_THREADS + 32;  // + one producer warp
constexpr long long WAIT_LIMIT = 1LL << 35;             // cycles (~19 s) before a wait traps

// Geometry of an 8 x TW output band. At TILES = TW/8 >= 2 each consumer
// warpgroup owns TPW = TILES/2 m64 tiles and all N; at TILES = 1 the two
// warpgroups share the tile and split N.
template <int TW>
struct Band {
  static_assert(TW == 8 || TW == 16 || TW == 32, "band width 8, 16 or 32");
  static constexpr int COLS = TW + 2;
  static constexpr int PLANE = COLS * COL_BYTES;       // A's LBO: one channel group
  static constexpr int IN_STAGE = 2 * PLANE;           // one 32-byte k-step
  static constexpr int TILES = TW / 8;
  static constexpr int TPW = TILES > 1 ? TILES / 2 : 1;
  static constexpr bool SPLIT_N = TILES == 1;
  // first tile and first output channel of warpgroup wg, for N channels
  __device__ static int tile0(int wg) { return SPLIT_N ? 0 : wg * TPW; }
  __device__ static int n0(int wg, int N) { return SPLIT_N ? wg * (N / 2) : 0; }
};

// Input channels per stage (one wgmma k-step: k16 bf16, k8 tf32) and the
// packed weight bytes of one stage: 9 taps x 32 B of K x N rows, twice for
// f32 (hi and lo).
template <typename T> __host__ __device__ constexpr int stage_channels() {
  return 32 / sizeof(T);
}
template <typename T, int N> __host__ __device__ constexpr int w_stage_bytes() {
  return 9 * 32 * N * (std::is_same<T, float>::value ? 2 : 1);
}
template <typename T, int N, int TW> __host__ __device__ constexpr int conv_smem_bytes() {
  return STAGES * (Band<TW>::IN_STAGE + w_stage_bytes<T, N>()) + 2 * STAGES * 8;
}
// The LeakyReLU slope and residual scale: 0.2 rounded to T (ops/cuda/rdb.py
// point_two), 0.2001953125 in bf16.
template <typename T> __host__ __device__ constexpr float point_two() {
  return std::is_same<T, float>::value ? 0.2f : 0.2001953125f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Arrives on the barrier at the same offset in block `rank` of the cluster,
// releasing at cluster scope what this thread has seen.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(bar), "r"(rank) : "memory");
}

// Spins until the barrier's phase with this parity has completed (acquire
// at CTA scope, or at cluster scope for a barrier other blocks arrive on).
// A wait that outlasts WAIT_LIMIT traps, so a broken pipeline fails the
// launch instead of hanging the card.
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  while (true) {
    uint32_t done;
    if constexpr (CLUSTER)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 < 0)
      t0 = clock64();
    else if (clock64() - t0 > WAIT_LIMIT)
      __trap();
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor, no swizzle (layout type 0): start address,
// LBO (next core matrix along K) and SBO (next 8 rows along M or N), all in
// 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}

// Pins each accumulator register at this point (an empty asm that reads and
// writes it), as CUTLASS's warpgroup_fence_operand: around the wgmma main
// loop it keeps the compiler from touching the accumulators while wgmmas are
// in flight, without which ptxas serialises the wgmmas (C7514).
template <int T, int R>
__device__ __forceinline__ void fence_acc(float (&acc)[T][R]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < R; ++r) asm volatile("" : "+f"(acc[t][r]) :: "memory");
}

// f32 -> the f32 bit pattern of its TF32 rounding (to nearest, ties away
// from zero; the low 13 bits cleared), as pack_weights rounds on the host.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// D[64 x N] += A[64 x 16] * B[16 x N], bf16, both K-major in shared memory.
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
          : "l"(da), "l"(db), "r"(1));
  }
};

// D[64 x N] += A[64 x 8] * B[8 x N], tf32: A's fragment in four registers
// (a0: M row 16q + lane/4, K column lane%4; a1: M row + 8; a2: K column + 4;
// a3: both), B K-major in shared memory.
template <int N> struct WgmmaTf32;

template <> struct WgmmaTf32<16> {
  __device__ __forceinline__ static void run(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaTf32<32> {
  __device__ __forceinline__ static void run(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaTf32<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// Shared-memory map of the five-launch kernels: [STAGES] bands, [STAGES]
// weight stages, then the full and empty barriers.
template <typename T, int N, int TW>
struct Ring {
  static constexpr int W_BYTES = w_stage_bytes<T, N>();
  static constexpr int IN_STAGE = Band<TW>::IN_STAGE;
  uint8_t* s_in;   // [STAGES][2][TW + 2][10][16 B]
  uint8_t* s_w;    // [STAGES][W_BYTES]
  uint32_t full0;  // full[s] at full0 + 8s
  uint32_t empty0; // empty[s] at empty0 + 8s

  __device__ __forceinline__ explicit Ring(uint8_t* smem)
      : s_in(smem), s_w(smem + STAGES * IN_STAGE),
        full0(smem_u32(s_w + STAGES * W_BYTES)), empty0(full0 + STAGES * 8) {}

  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // The producer warp: one lane keeps the ring full, stage i holding the
  // band's channels [i*KC, (i+1)*KC) and their packed weights.
  __device__ __forceinline__ void produce(const CUtensorMap* band, const T* w, int chunks,
                                          int ty0, int tx0, int b) const {
    if (threadIdx.x % 32 != 0) return;
    const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
    for (int i = 0; i < chunks; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, IN_STAGE + W_BYTES);
      tma_load_5d(smem_u32(s_in + s * IN_STAGE), band, full, 0, ty0 - 1, tx0 - 1, 2 * i, b);
      bulk_load(smem_u32(s_w + s * W_BYTES), wb + (size_t)i * W_BYTES, W_BYTES, full);
    }
  }
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Epilogue of one consumer warpgroup: TPW m64 tiles from column col0, output
// channels [n0, n0 + NW). Accumulator fragment of m64nNW: warp q of the
// group holds M rows 16q + lane/4 (+8); with M = column*8 + row that is band
// row lane/4 of columns 2q (and 2q+1); registers 4j..4j+3 hold channels
// n0 + 8j + 2(lane%4) and +1 of those two pixels. buf is read only for the
// residual of launch 4; buf and out may alias.
template <typename T, int NW, int TPW>
__device__ __forceinline__ void store_band(const float (&acc)[TPW][NW / 2],
                                           const float* __restrict__ bias, const T* buf, T* out,
                                           int b, int ty0, int col0, int n0, int H, int W,
                                           int ctot, int out_stride, int out_off, int residual) {
  const int q = (threadIdx.x % WG_THREADS) / 32;
  const int lane = threadIdx.x % 32;
  const int gy = ty0 + lane / 4;
  if (gy >= H) return;
#pragma unroll
  for (int t = 0; t < TPW; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = col0 + t * 8 + 2 * q + h;
      if (gx >= W) continue;
      const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int co = n0 + 8 * j + 2 * (lane % 4);
        float v0 = acc[t][4 * j + 2 * h] + bias[co];
        float v1 = acc[t][4 * j + 2 * h + 1] + bias[co + 1];
        constexpr float c = point_two<T>();
        if (residual) {
          const float2 x = load2(buf + pix * ctot + co);
          v0 = c * v0 + x.x;
          v1 = c * v1 + x.y;
        } else {
          v0 = v0 >= 0.f ? v0 : c * v0;
          v1 = v1 >= 0.f ? v1 : c * v1;
        }
        store2(out + pix * out_stride + out_off + co, v0, v1);
      }
    }
  }
}

// One conv of the RDB for an 8 x 32 band and all N output channels, bf16.
// `band` is the tensor map of buf (see rdb_forward).
template <int N>
__global__ void __launch_bounds__(WGMMA_THREADS, 2)
dense_conv3x3_wgmma(const __grid_constant__ CUtensorMap band,
                    const __nv_bfloat16* __restrict__ w,  // [cin/16][9][2][N][8]
                    const float* __restrict__ bias,       // [N]
                    const __nv_bfloat16* buf,              // [B, H, W, ctot]
                    __nv_bfloat16* out,                    // [B, H, W, out_stride]
                    int H, int W, int ctot, int cin,
                    int out_stride, int out_off, int residual) {
  constexpr int TW = 32;
  using G = Band<TW>;
  extern __shared__ __align__(128) uint8_t smem[];  // TMA, no swizzle: 128 B
  const Ring<__nv_bfloat16, N, TW> ring(smem);
  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.z;
  const int chunks = cin / stage_channels<__nv_bfloat16>();
  const int wg = threadIdx.x / WG_THREADS;
  ring.init();
  if (wg == CONSUMERS) {
    ring.produce(&band, w, chunks, ty0, tx0, b);
    return;
  }

  float acc[G::TPW][N / 2];
#pragma unroll
  for (int t = 0; t < G::TPW; ++t)
#pragma unroll
    for (int r = 0; r < N / 2; ++r) acc[t][r] = 0.f;

  const uint32_t in0 = smem_u32(ring.s_in) + G::tile0(wg) * 8 * COL_BYTES;
  const uint32_t w0 = smem_u32(ring.s_w);
  const bool leader = threadIdx.x % WG_THREADS == 0;
  for (int i = 0; i < chunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(ring.full0 + 8 * s, (i / STAGES) & 1);
    const uint64_t da = smem_desc(in0 + s * G::IN_STAGE, G::PLANE, COL_BYTES);
    const uint64_t db = smem_desc(w0 + s * ring.W_BYTES, N * 16, 128);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t dbt = db + ((tap * 2 * N * 16) >> 4);
#pragma unroll
      for (int t = 0; t < G::TPW; ++t)
        Wgmma<N>::run(acc[t], da + (((t * 8 + dx) * COL_BYTES + dy * 16) >> 4), dbt);
    }
    wgmma_commit();
    // the group of chunk i-1 has retired: its stage may be refilled
    wgmma_wait<1>();
    if (i > 0 && leader) mbar_arrive(ring.empty0 + 8 * ((i - 1) % STAGES));
  }
  wgmma_wait<0>();
  store_band<__nv_bfloat16, N, G::TPW>(acc, bias, buf, out, b, ty0, tx0 + G::tile0(wg) * 8, 0,
                                       H, W, ctot, out_stride, out_off, residual);
}

// One conv of the RDB for an 8 x TW band and all N output channels, f32 by
// three TF32 products (see the head of this file).
template <int N, int TW>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
dense_conv3x3_tf32x3(const __grid_constant__ CUtensorMap band,
                     const float* __restrict__ w,  // [cin/8][9][2][hi N | lo N][4]
                     const float* __restrict__ bias,  // [N]
                     const float* buf,                // [B, H, W, ctot]
                     float* out,                      // [B, H, W, out_stride]
                     int H, int W, int ctot, int cin,
                     int out_stride, int out_off, int residual) {
  using G = Band<TW>;
  constexpr int NW = G::SPLIT_N ? N / 2 : N;  // this warpgroup's output channels
  extern __shared__ __align__(128) uint8_t smem[];
  const Ring<float, N, TW> ring(smem);
  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.z;
  const int chunks = cin / stage_channels<float>();
  const int wg = threadIdx.x / WG_THREADS;
  ring.init();
  if (wg == CONSUMERS) {
    ring.produce(&band, w, chunks, ty0, tx0, b);
    return;
  }
  const int n0 = G::n0(wg, N);

  float acc[G::TPW][NW / 2];
#pragma unroll
  for (int t = 0; t < G::TPW; ++t)
#pragma unroll
    for (int r = 0; r < NW / 2; ++r) acc[t][r] = 0.f;

  // This thread's A fragment of tile t, tap (dy, dx): M row 16q + lane/4
  // (+8) is band row lane/4 + dy of column 8(tile0 + t) + 2q + dx (+1); K
  // column lane%4 (+4) is element lane%4 of channel plane 0 (1).
  const int q = (threadIdx.x % WG_THREADS) / 32;
  const int lane = threadIdx.x % 32;
  const float* a0 = reinterpret_cast<const float*>(
      ring.s_in + (8 * G::tile0(wg) + 2 * q) * COL_BYTES + (lane / 4) * 16 + (lane % 4) * 4);
  const uint32_t w0 = smem_u32(ring.s_w) + n0 * 16;
  const bool leader = threadIdx.x % WG_THREADS == 0;
  uint32_t hi[2][8], lo[2][8];  // two register sets: [column c][plane p] at 2c + p
  fence_acc(acc);
  for (int i = 0; i < chunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(ring.full0 + 8 * s, (i / STAGES) & 1);
    const float* a_s = a0 + s * (G::IN_STAGE / 4);
    const uint32_t w_s = w0 + s * ring.W_BYTES;
    // 3 * TPW units (dy, tile), one wgmma group each; set u % 2
#pragma unroll
    for (int u = 0; u < 3 * G::TPW; ++u) {
      const int dy = u / G::TPW, t = u % G::TPW, r = u % 2;
      // the group that read set r (two units back) retires; from the second
      // unit on, every group of stage i-1 has, so its stage may be refilled
      wgmma_wait<1>();
      if (u == 1 && i > 0 && leader) mbar_arrive(ring.empty0 + 8 * ((i - 1) % STAGES));
      const float* a = a_s + (t * 8 * COL_BYTES + dy * 16) / 4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float v = a[(p * G::PLANE + c * COL_BYTES) / 4];
          const uint32_t h = tf32_bits(v);
          hi[r][2 * c + p] = h;
          lo[r][2 * c + p] = tf32_bits(v - __uint_as_float(h));
        }
      wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t ah[4] = {hi[r][2 * dx], hi[r][2 * dx + 2], hi[r][2 * dx + 1],
                                hi[r][2 * dx + 3]};
        const uint32_t al[4] = {lo[r][2 * dx], lo[r][2 * dx + 2], lo[r][2 * dx + 1],
                                lo[r][2 * dx + 3]};
        // B of tap (dy, dx): 2 K halves x 2N rows x 16 B; lo starts N rows on;
        // this warpgroup's channels start n0 rows on (w0)
        const uint64_t dbh = smem_desc(w_s + (dy * 3 + dx) * 64 * N, 2 * N * 16, 128);
        const uint64_t dbl = dbh + ((N * 16) >> 4);
        WgmmaTf32<NW>::run(acc[t], ah, dbh);
        WgmmaTf32<NW>::run(acc[t], al, dbh);
        WgmmaTf32<NW>::run(acc[t], ah, dbl);
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  store_band<float, NW, G::TPW>(acc, bias, buf, out, b, ty0, tx0 + 8 * G::tile0(wg), n0, H, W,
                                ctot, out_stride, out_off, residual);
}

// ---------------------------------------------------------------------------
// Design B: the whole RDB in one launch on a cluster (bf16, nf 64, g 32).

constexpr int C_NF = 64, C_G = 32, C_CT = C_NF + 4 * C_G;  // 192 concat channels
constexpr int C_GROUPS = C_CT / 8;                          // 16-byte channel groups
constexpr int C_W_STAGE = 9 * 32 * 64;  // bytes of the largest k-step's weights (N = 64)
constexpr int C_CHUNKS = 40;            // k-steps of the five convs: 4 + 6 + 8 + 10 + 12
constexpr int MAX_CLUSTER = 16;

// First k-step of conv k (k = 5: the end): 4 + 6 + ... = k(k + 3).
__host__ __device__ constexpr int conv_start(int k) { return k * (k + 3); }

// The resident concat, the weight stages, the barriers, the biases, and at
// TW = 8 the two warpgroups' exchange of partial sums: 203 KB at TW = 8,
// 144 KB at 16.
template <int TW>
struct ClusterSmem {
  // at TW = 8 (one m64 tile) the warpgroups split the k-steps, not N
  static constexpr bool KSPLIT = Band<TW>::TILES == 1;
  // 4 stages ahead of each warpgroup: at KSPLIT each reads every other one
  static constexpr int STAGES = KSPLIT ? 8 : 4;
  static constexpr int RES = C_GROUPS * Band<TW>::PLANE;  // the resident concat
  static constexpr int W0 = RES;                          // weight stages
  static constexpr int BARS = W0 + STAGES * C_W_STAGE;    // full[S], empty[S], x, conv
  static constexpr int BIAS = BARS + (2 * STAGES + 2) * 8;
  static constexpr int RED = BIAS + C_CT * 4;             // [2][128 threads][16] f32
  static constexpr int BYTES = RED + (KSPLIT ? 2 * WG_THREADS * (C_NF / 4) * 4 : 0);
  static_assert(RES % 128 == 0, "the TMA destination and weight stages stay aligned");
};

struct WeightPtrs {
  const __nv_bfloat16* w[5];
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Orders this thread's generic accesses to its block's shared memory with
// the async proxy's (the wgmma reads); at CTA scope it costs nothing, where
// the form without a state space measured ~1 us a call on an H100.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Every thread of the cluster reaches this point, once, at the start,
// before any block touches another's shared memory (the conv barriers are
// mbarriers, which must be initialised first).
__device__ __forceinline__ void cluster_start() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// The 256 consumer threads of the block (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS * WG_THREADS) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16x2(float v0, float v1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The block's place in its image: band (by, bx) of nby x nbx, rank in the
// cluster, and the shared-memory addresses every stage reads.
template <int TW>
struct ClusterBlock {
  using G = Band<TW>;
  using S = ClusterSmem<TW>;
  uint8_t* smem;
  const float* bias;  // the five biases, staged in shared memory
  float* red;         // S::RED: partial sums passed between the warpgroups
  uint32_t base, full0, empty0, xbar, convbar;
  int rank, nbx, nby, n, by, bx, y0, x0, b, H, W;

  __device__ __forceinline__ ClusterBlock(uint8_t* s, int H_, int W_)
      : smem(s), bias(reinterpret_cast<const float*>(s + S::BIAS)),
        red(reinterpret_cast<float*>(s + S::RED)), base(smem_u32(s)), full0(base + S::BARS),
        empty0(full0 + 8 * S::STAGES), xbar(empty0 + 8 * S::STAGES), convbar(xbar + 8),
        rank(cluster_rank()), nbx((W_ + TW - 1) / TW), nby((H_ + TH - 1) / TH), n(nbx * nby),
        by(rank / nbx), bx(rank % nbx), y0(by * TH), x0(bx * TW), b(blockIdx.y), H(H_),
        W(W_) {}

  // byte offset of channel ch (even) at band row ri, column ci of the
  // resident buffer
  __device__ __forceinline__ static int at(int ch, int ri, int ci) {
    return (ch / 8) * G::PLANE + ci * COL_BYTES + ri * 16 + (ch % 8) * 2;
  }

  // Frees stage s of the ring (the warpgroup's first thread, once its
  // wgmma groups that read s retired).
  __device__ __forceinline__ void release(int s) const {
    if (threadIdx.x % WG_THREADS == 0) mbar_arrive(empty0 + 8 * s);
  }

  // Every block's consumers are past conv k, halos included: the block's
  // 256 consumer threads meet, one thread a block arrives on every block's
  // conv barrier (release at cluster scope) and all wait on their own
  // (acquire at cluster scope, bounded by WAIT_LIMIT). The fences order
  // the generic stores with the next conv's wgmma (the async proxy); the
  // form without a state space cost ~1 us a call on an H100.
  __device__ __forceinline__ void conv_done(int k) const {
    fence_proxy_async();
    consumers_sync();
    if (threadIdx.x < n) mbar_arrive_remote(convbar, threadIdx.x);
    mbar_wait<true>(convbar, k & 1);
    fence_proxy_async();
  }

  // The producer: k-step gi of the 40 into its stage, once the consumers
  // freed the stage's previous k-step.
  __device__ __forceinline__ void load_chunk(const WeightPtrs& weights, int gi) const {
    int k = 0;
    while (gi >= conv_start(k + 1)) ++k;
    const int wb = 9 * 32 * (k < 4 ? C_G : C_NF);  // one k-step's weight bytes
    const int s = gi % S::STAGES;
    if (gi >= S::STAGES) mbar_wait(empty0 + 8 * s, ((gi / S::STAGES) - 1) & 1);
    mbar_expect_tx(full0 + 8 * s, wb);
    bulk_load(base + S::W0 + s * C_W_STAGE,
              reinterpret_cast<const uint8_t*>(weights.w[k]) + (size_t)(gi - conv_start(k)) * wb,
              wb, full0 + 8 * s);
  }

  // Conv k's 32 new channels on this band's edges into the halo slots of
  // the neighbours that see them: 16-byte DSMEM stores (one channel group
  // of one pixel each), spread over the consumer threads. An edge pixel
  // past the image's edge is zero here and in the neighbour's slot, so
  // whole edges are copied.
  __device__ __forceinline__ void send_halos(int k) const {
    int idx = threadIdx.x;  // < 256: at most 2*TW*4 + 2*8*4 + 4*4 items
#pragma unroll
    for (int d = 0; d < 9; ++d) {
      const int dyn = d / 3 - 1, dxn = d % 3 - 1;
      if (d == 4 || by + dyn < 0 || by + dyn >= nby || bx + dxn < 0 || bx + dxn >= nbx)
        continue;
      const int nr = dyn ? 1 : TH, nc = dxn ? 1 : TW, count = nr * nc * 4;
      if (idx >= 0 && idx < count) {
        const int grp = idx % 4, p = idx / 4;
        const int ri = dyn < 0 ? 1 : dyn > 0 ? TH : 1 + p / nc;
        const int ci = dxn < 0 ? 1 : dxn > 0 ? TW : 1 + p % nc;
        const int g = C_NF / 8 + 4 * k + grp;
        const uint4 v = *reinterpret_cast<const uint4*>(
            smem + g * G::PLANE + ci * COL_BYTES + ri * 16);
        const uint32_t dst = base + g * G::PLANE + (ci - dxn * TW) * COL_BYTES
                             + (ri - dyn * TH) * 16;
        const uint32_t peer = (by + dyn) * nbx + bx + dxn;
        asm volatile(
            "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
            " st.shared::cluster.v4.u32 [ra], {%2, %3, %4, %5};\n}\n"
            :: "r"(dst), "r"(peer), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
      }
      idx -= count;
    }
  }
};

// Conv k of the RDB in one block: its k-steps from the ring (global k-step
// index gi on entry), A from the resident concat, then the epilogue into
// the resident buffer (k < 4) or out (k = 4). At TW = 16 each warpgroup
// owns one m64 tile and all N; at TW = 8 the two share the tile and take
// alternate k-steps with all N (wgmma at N = 16 ran at a quarter of the
// tensor cores' rate), then pass each other half of their partial sums
// through shared memory and store N/2 channels each.
template <int N, int TW>
__device__ __forceinline__ void cluster_conv(const ClusterBlock<TW>& blk, int k, int& gi,
                                             __nv_bfloat16* __restrict__ out,
                                             __nv_bfloat16* __restrict__ cat, int wg) {
  using G = Band<TW>;
  using S = ClusterSmem<TW>;
  constexpr bool KSPLIT = S::KSPLIT;
  constexpr int R = N / 2;  // accumulator registers: all N of one tile
  const int tile = KSPLIT ? 0 : wg;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  const uint32_t w0 = blk.base + S::W0;
  const int chunks = conv_start(k + 1) - conv_start(k);
  int last = -1;  // this warpgroup's previous k-step, whose stage it frees
  for (int j = KSPLIT ? wg : 0; j < chunks; j += KSPLIT ? 2 : 1) {
    const int g = gi + j, s = g % S::STAGES;
    mbar_wait(blk.full0 + 8 * s, (g / S::STAGES) & 1);
    const uint64_t da = smem_desc(blk.base + 2 * j * G::PLANE + tile * 8 * COL_BYTES, G::PLANE,
                                  COL_BYTES);
    const uint64_t db = smem_desc(w0 + s * C_W_STAGE, N * 16, 128);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      Wgmma<N>::run(acc, da + ((dx * COL_BYTES + dy * 16) >> 4),
                    db + ((tap * 2 * N * 16) >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (last >= 0) blk.release(last % S::STAGES);
    last = g;
  }
  wgmma_wait<0>();
  blk.release(last % S::STAGES);
  gi += chunks;

  // This warpgroup's output channels [n0, n0 + NE) and their sums: at
  // KSPLIT it sends the other warpgroup the registers of that one's half
  // and adds what it gets back (fragment registers 4j..4j+3 hold channels
  // 8j.., so a half of N is a half of the registers).
  constexpr int NE = KSPLIT ? N / 2 : N;
  const int n0 = KSPLIT ? wg * NE : 0;
  const int tid = threadIdx.x % WG_THREADS;
  if constexpr (KSPLIT) {
    float* to = blk.red + ((1 - wg) * WG_THREADS + tid) * (R / 2);
#pragma unroll
    for (int i = 0; i < R / 2; ++i) to[i] = wg ? acc[i] : acc[R / 2 + i];
    consumers_sync();
    const float* from = blk.red + (wg * WG_THREADS + tid) * (R / 2);
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      if (wg)
        acc[R / 2 + i] += from[i];
      else
        acc[i] += from[i];
    }
  }

  // register i of this warpgroup's channels
  auto sum = [&](int i) {
    if constexpr (KSPLIT)
      return wg ? acc[R / 2 + i] : acc[i];
    else
      return acc[i];
  };

  // Epilogue: see store_band for the fragment map.
  const int q = tid / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane / 4, gy = blk.y0 + r;
  constexpr float c = point_two<__nv_bfloat16>();
  if (gy < blk.H) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = tile * 8 + 2 * q + h, gx = blk.x0 + col;
      if (gx >= blk.W) continue;
      const size_t pix = ((size_t)blk.b * blk.H + gy) * blk.W + gx;
#pragma unroll
      for (int jj = 0; jj < NE / 8; ++jj) {
        const int co = n0 + 8 * jj + 2 * (lane % 4);
        float v0 = sum(4 * jj + 2 * h) + blk.bias[k * C_G + co];
        float v1 = sum(4 * jj + 2 * h + 1) + blk.bias[k * C_G + co + 1];
        if (k == 4) {
          const uint32_t xv =
              *reinterpret_cast<const uint32_t*>(blk.smem + blk.at(co, r + 1, col + 1));
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
          store2(out + pix * C_NF + co, c * v0 + x.x, c * v1 + x.y);
          if (cat) *reinterpret_cast<uint32_t*>(cat + pix * C_CT + co) = xv;
          continue;
        }
        v0 = v0 >= 0.f ? v0 : c * v0;
        v1 = v1 >= 0.f ? v1 : c * v1;
        const uint32_t pv = pack_bf16x2(v0, v1);
        const int ch = C_NF + k * C_G + co;
        *reinterpret_cast<uint32_t*>(blk.smem + blk.at(ch, r + 1, col + 1)) = pv;
        if (cat) *reinterpret_cast<uint32_t*>(cat + pix * C_CT + ch) = pv;
      }
    }
  }
  if (k < 4) {
    consumers_sync();  // the band's new channels are in place: its edges go out
    blk.send_halos(k);
  }
}

// One whole RDB for one image per cluster, bf16 (see the head of this file,
// design B). Grid (cluster size, B); cluster (cluster size, 1, 1).
template <int TW>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
rdb_cluster_wgmma(const __grid_constant__ CUtensorMap xmap,  // x [B, H, W, 64]
                  const WeightPtrs weights,                  // packed, conv1..conv5
                  const float* __restrict__ bias,            // [4g + nf]
                  __nv_bfloat16* __restrict__ out,           // [B, H, W, 64]
                  __nv_bfloat16* __restrict__ cat,           // [B, H, W, 192] or null
                  int H, int W) {
  using G = Band<TW>;
  using S = ClusterSmem<TW>;
  extern __shared__ __align__(128) uint8_t smem[];
  const ClusterBlock<TW> blk(smem, H, W);
  const int wg = threadIdx.x / WG_THREADS;
  const bool producer = wg == CONSUMERS && threadIdx.x % 32 == 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(blk.full0 + 8 * s, 1);
      mbar_init(blk.empty0 + 8 * s, S::KSPLIT ? 1 : CONSUMERS);  // the warpgroups reading s
    }
    mbar_init(blk.xbar, 1);
    mbar_init(blk.convbar, blk.n);  // one arrival from each block
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // x and the first k-steps load while the block zeroes x1..x4 and the
  // cluster meets: both go only to this block's shared memory
  if (producer) {
    mbar_expect_tx(blk.xbar, (C_NF / 8) * G::PLANE);
    tma_load_5d(blk.base, &xmap, blk.xbar, 0, blk.y0 - 1, blk.x0 - 1, 0, blk.b);
    for (int gi = 0; gi < S::STAGES; ++gi) blk.load_chunk(weights, gi);
  }
  // x1..x4 start zero: the padding at and past the image's edge stays so
  {
    uint4* z = reinterpret_cast<uint4*>(smem + (C_NF / 8) * G::PLANE);
    constexpr int n16 = (C_GROUPS - C_NF / 8) * G::PLANE / 16;
    for (int i = threadIdx.x; i < n16; i += WGMMA_THREADS) z[i] = make_uint4(0, 0, 0, 0);
    float* sb = reinterpret_cast<float*>(smem + S::BIAS);
    for (int i = threadIdx.x; i < C_CT; i += WGMMA_THREADS) sb[i] = bias[i];
  }
  fence_proxy_async();  // the zeros, for the wgmmas that read the padding
  cluster_start();      // every block's buffers are zero and barriers set up

  if (wg == CONSUMERS) {  // the producer warp: one lane, ahead of the convs
    if (producer)
      for (int gi = S::STAGES; gi < C_CHUNKS; ++gi) blk.load_chunk(weights, gi);
    return;
  }

  mbar_wait(blk.xbar, 0);
  int gi = 0;
  for (int k = 0; k < 4; ++k) {
    cluster_conv<C_G, TW>(blk, k, gi, out, cat, wg);
    blk.conv_done(k);  // conv k's channels, halos included, are in place everywhere
  }
  // conv 5 reads and writes only this block's shared memory, and every
  // arrival on this block's conv barrier came before the last wait: no
  // block touches another's from here, so each may leave on its own
  cluster_conv<C_NF, TW>(blk, 4, gi, out, cat, wg);
}

// Errors of the host code's own, beside CUDA's (which are >= 0).
constexpr int ERR_NO_DRIVER_ENTRY = -1;  // cuTensorMapEncodeTiled not found in libcuda
constexpr int ERR_TENSOR_MAP = -2;       // cuTensorMapEncodeTiled refused the map
constexpr int ERR_SHAPE = -3;            // nf or g not 32 or 64, or a band width not built
constexpr int ERR_CLUSTER_SHAPE = -4;    // cluster route: not nf 64, g 32, or > 16 bands
constexpr int ERR_CLUSTER_FIT = -5;      // cudaOccupancyMaxActiveClusters found no place

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's encoder, from the libcuda the CUDA runtime already loaded
// (no link against the driver library at build time).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A tensor map over t [B, H, W, ctot] viewed as (16 B of channels, H, W,
// ctot/GROUP channel groups, B), innermost first, with a box of `groups`
// channel groups x 10 rows x (TW + 2) columns: one band with its halo.
template <typename T>
int band_map(CUtensorMap* map, const T* t, int B, int H, int W, int ctot, int cols, int groups) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_DRIVER_ENTRY;
  constexpr int E = sizeof(T);
  constexpr int GROUP = 16 / E;  // channels in one 16-byte core-matrix row
  const cuuint64_t dims[5] = {GROUP, (cuuint64_t)H, (cuuint64_t)W, (cuuint64_t)(ctot / GROUP),
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)W * ctot * E, (cuuint64_t)ctot * E, 16,
                                 (cuuint64_t)H * W * ctot * E};
  const cuuint32_t box[5] = {GROUP, BAND_ROWS, (cuuint32_t)cols, (cuuint32_t)groups, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (encode(map, type, 5, const_cast<T*>(t), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  return 0;
}

template <typename T, int N, int TW>
using ConvKernel = void (*)(CUtensorMap, const T*, const float*, const T*, T*, int, int, int,
                            int, int, int, int);

template <typename T, int N, int TW>
constexpr ConvKernel<T, N, TW> conv_kernel() {
  if constexpr (std::is_same<T, float>::value)
    return dense_conv3x3_tf32x3<N, TW>;
  else
    return dense_conv3x3_wgmma<N>;
}

// Runs `set` (the kernel's attributes) once per device; its error, if any.
template <typename Set>
cudaError_t once_per_device(std::atomic<uint64_t>& done, Set set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int N, int TW>
int launch_conv(const CUtensorMap& map, const void* w, const float* bias, const T* buf, T* out,
                int B, int H, int W, int ctot, int cin, int out_stride, int out_off,
                int residual, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t err = once_per_device(done, [] {
    return cudaFuncSetAttribute(conv_kernel<T, N, TW>(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                conv_smem_bytes<T, N, TW>());
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), 1, B);
  const ConvKernel<T, N, TW> kernel = conv_kernel<T, N, TW>();
  kernel<<<grid, WGMMA_THREADS, conv_smem_bytes<T, N, TW>(), stream>>>(
      map, static_cast<const T*>(w), bias, buf, out, H, W, ctot, cin, out_stride, out_off,
      residual);
  return static_cast<int>(cudaGetLastError());
}

// The five launches of one RDB at band width TW. buf holds x in channels
// [0, nf); w[k] is conv k's packed weight; bias is the five biases
// concatenated (f32, 4g + nf).
template <typename T, int TW>
int rdb_forward_tw(T* buf, const void* const* w, const float* bias, T* out, int B, int H, int W,
                   int nf, int g, cudaStream_t stream) {
  const int ctot = nf + 4 * g;
  CUtensorMap map;
  const int merr = band_map(&map, buf, B, H, W, ctot, TW + 2, 2);
  if (merr) return merr;
  for (int k = 0; k < 5; ++k) {
    const int cin = nf + k * g;
    const bool last = k == 4;
    const int cout = last ? nf : g;
    T* dst = last ? out : buf;
    const int stride = last ? nf : ctot, off = last ? 0 : cin;
    const int err = cout == 32
        ? launch_conv<T, 32, TW>(map, w[k], bias + k * g, buf, dst, B, H, W, ctot, cin, stride,
                                 off, last, stream)
        : launch_conv<T, 64, TW>(map, w[k], bias + k * g, buf, dst, B, H, W, ctot, cin, stride,
                                 off, last, stream);
    if (err) return err;
  }
  return 0;
}

template <typename T>
int rdb_forward(T* buf, const void* const* w, const float* bias, T* out, int B, int H, int W,
                int nf, int g, int tw, cudaStream_t stream) {
  if ((nf != 32 && nf != 64) || (g != 32 && g != 64)) return ERR_SHAPE;
  if constexpr (std::is_same<T, float>::value) {
    switch (tw) {
      case 32: return rdb_forward_tw<T, 32>(buf, w, bias, out, B, H, W, nf, g, stream);
      case 16: return rdb_forward_tw<T, 16>(buf, w, bias, out, B, H, W, nf, g, stream);
      case 8: return rdb_forward_tw<T, 8>(buf, w, bias, out, B, H, W, nf, g, stream);
      default: return ERR_SHAPE;
    }
  } else {
    return tw == 32 ? rdb_forward_tw<T, 32>(buf, w, bias, out, B, H, W, nf, g, stream)
                    : ERR_SHAPE;
  }
}

template <int TW>
cudaLaunchConfig_t cluster_config(int n, int B, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, B, 1);
  cfg.blockDim = dim3(WGMMA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = ClusterSmem<TW>::BYTES;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int TW>
cudaError_t cluster_attributes() {
  static std::atomic<uint64_t> done{0};
  return once_per_device(done, [] {
    cudaError_t err = cudaFuncSetAttribute(rdb_cluster_wgmma<TW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           ClusterSmem<TW>::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rdb_cluster_wgmma<TW>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  });
}

// How many clusters of n blocks the card can hold at once (0: none fits);
// negative on an error.
template <int TW>
int cluster_capacity(int n) {
  const cudaError_t err = cluster_attributes<TW>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<TW>(n, 1, nullptr, &attr);
  int clusters = 0;
  const cudaError_t qerr = cudaOccupancyMaxActiveClusters(&clusters, rdb_cluster_wgmma<TW>, &cfg);
  return qerr == cudaSuccess ? clusters : -static_cast<int>(qerr);
}

template <int TW>
int rdb_cluster(const __nv_bfloat16* x, const void* const* w, const float* bias,
                __nv_bfloat16* out, __nv_bfloat16* cat, int B, int H, int W,
                cudaStream_t stream) {
  const int n = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (n > MAX_CLUSTER) return ERR_CLUSTER_SHAPE;
  // capacity of each cluster size, asked once: 0 unknown, 1 fits, 2 does not
  static std::atomic<int> fits[MAX_CLUSTER + 1];
  if (fits[n].load() == 0) {
    const int cap = cluster_capacity<TW>(n);
    if (cap < 0) return -cap;
    fits[n].store(cap > 0 ? 1 : 2);
  }
  if (fits[n].load() != 1) return ERR_CLUSTER_FIT;
  CUtensorMap map;
  const int merr = band_map(&map, x, B, H, W, C_NF, TW + 2, C_NF / 8);
  if (merr) return merr;
  WeightPtrs wp;
  for (int k = 0; k < 5; ++k) wp.w[k] = static_cast<const __nv_bfloat16*>(w[k]);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<TW>(n, B, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rdb_cluster_wgmma<TW>, map, wp, bias, out,
                                             cat, H, W);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ssr_rdb_forward_f32(void* buf, const void* w0, const void* w1, const void* w2,
                        const void* w3, const void* w4, const void* bias, void* out,
                        int B, int H, int W, int nf, int g, int tw, void* stream) {
  const void* w[5] = {w0, w1, w2, w3, w4};
  return rdb_forward(static_cast<float*>(buf), w, static_cast<const float*>(bias),
                     static_cast<float*>(out), B, H, W, nf, g, tw,
                     static_cast<cudaStream_t>(stream));
}

int ssr_rdb_forward_bf16(void* buf, const void* w0, const void* w1, const void* w2,
                         const void* w3, const void* w4, const void* bias, void* out,
                         int B, int H, int W, int nf, int g, int tw, void* stream) {
  const void* w[5] = {w0, w1, w2, w3, w4};
  return rdb_forward(static_cast<__nv_bfloat16*>(buf), w, static_cast<const float*>(bias),
                     static_cast<__nv_bfloat16*>(out), B, H, W, nf, g, tw,
                     static_cast<cudaStream_t>(stream));
}

// Design B: x [B, H, W, 64] -> out; cat [B, H, W, 192] (x, x1..x4) when not
// null. nf 64 and g 32 only; tw 16 or 8.
int ssr_rdb_cluster_bf16(const void* x, const void* w0, const void* w1, const void* w2,
                         const void* w3, const void* w4, const void* bias, void* out, void* cat,
                         int B, int H, int W, int nf, int g, int tw, void* stream) {
  if (nf != C_NF || g != C_G) return ERR_CLUSTER_SHAPE;
  const void* w[5] = {w0, w1, w2, w3, w4};
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* c = static_cast<__nv_bfloat16*>(cat);
  const auto* bs = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (tw) {
    case 16: return rdb_cluster<16>(xb, w, bs, o, c, B, H, W, st);
    case 8: return rdb_cluster<8>(xb, w, bs, o, c, B, H, W, st);
    default: return ERR_CLUSTER_SHAPE;
  }
}

// Clusters of n blocks of design B at band width tw the card holds at once
// (cudaOccupancyMaxActiveClusters); a negative CUDA error on failure.
int ssr_rdb_cluster_capacity(int tw, int n) {
  switch (tw) {
    case 16: return cluster_capacity<16>(n);
    case 8: return cluster_capacity<8>(n);
    default: return ERR_CLUSTER_SHAPE;
  }
}

const char* ssr_cuda_error_string(int code) {
  switch (code) {
    case ERR_NO_DRIVER_ENTRY: return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused the band's tensor map";
    case ERR_SHAPE:
      return "the rdb kernel (float32 and bfloat16 routes) takes nf and g of 32 or 64, and "
             "band widths 32, 16, 8 (float32) or 32 (bfloat16)";
    case ERR_CLUSTER_SHAPE:
      return "the cluster rdb kernel takes nf 64, g 32, band width 16 or 8 and at most 16 "
             "bands an image";
    case ERR_CLUSTER_FIT:
      return "the cluster rdb kernel's cluster does not fit on this card "
             "(cudaOccupancyMaxActiveClusters = 0)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"

// ResidualDenseBlock of the RRDBNet trunk, for Hopper (sm_90a).
//
// Replaces satlas_sr_tpu/ops/pallas/rdb.py:129 rdb_pallas, in both of its
// dtypes (float32 and bfloat16). One RDB is
//   x_{k+1} = lrelu_0.2(conv3x3_k(concat(x, x_1 .. x_k)))   for k = 0..3
//   out     = x + 0.2 * conv3x3_4(concat(x, x_1 .. x_4))
// over NHWC tensors, with nf = 64 feature and g = 32 growth channels at the
// flagship width. Both routes take nf and g of 32 or 64 (the wgmma widths N
// they are built for); anything else is refused with ERR_SHAPE.
//
// The wrapper allocates one channels-last dense-concat buffer
// [B, H, W, nf + 4g] and copies x into channels [0, nf). Launch k reads
// channels [0, nf + k*g) and, for k < 4, writes its g output channels at
// [nf + k*g, nf + (k+1)*g) of the same buffer, so the concat is never
// materialised; launch 4 writes x + 0.2*conv to the output tensor.
//
// Each conv is an implicit GEMM on the tensor cores, M = an 8-row x 32-column
// output band of one image (256 pixels), N = cout (32, or 64 for conv5),
// K = 9 taps x cin, accumulated in f32 by wgmma. One block per band, both
// routes with the same pipeline:
// - A (pixels x channels) is never copied per tap. A TMA tiled load writes
//   the band with its halo, 10 rows x 34 columns x 32 bytes of channels (16
//   bf16 or 8 f32: one wgmma k-step), as [channel group][column][row][16 B]:
//   the tensor map views buf as (16 B of channels, H, W, channel groups, B),
//   innermost first, and its out-of-bounds zero fill, starting at row -1 and
//   column -1, is the conv's zero padding. In that order 8 consecutive M rows
//   (8 rows of one column) are one 8 x 16 B core matrix of wgmma's
//   no-swizzle layout: an m64 tile is 8 rows x 8 columns, SBO is one column
//   (160 B), LBO one channel-group plane (5440 B), and tap (dy, dx) adds
//   dy*16 + dx*160 bytes, so all nine taps read the same staged band.
// - B (weights) is packed on the host (ops/cuda/rdb.py pack_weights) into the
//   exact shared-memory image the B descriptor reads and moved by one 1-D
//   bulk copy per stage.
// - A ring of 3 stages of (one k-step of input channels, their weights),
//   filled by one producer warp (TMA + bulk copy, completed on the stage's
//   mbarrier) while two consumer warpgroups, each owning two m64 tiles (16
//   columns), run the nine taps' wgmmas; a consumer frees a stage once the
//   wgmma groups that read it have retired.
// - Epilogue in registers: bias, LeakyReLU (launches 0-3) or 0.2*v + x
//   (launch 4), one rounding to the tensor's type, stored straight into the
//   concat buffer's channel slice or out. The 0.2 is 0.2 in the tensor's
//   type (point_two: 0.2001953125 in bf16), as the JAX block's constants are.
//
// bfloat16 (dense_conv3x3_wgmma): wgmma.m64nNk16.bf16 with A and B both read
// through shared-memory descriptors. Two blocks fit on an SM.
//
// float32 (dense_conv3x3_tf32x3): f32 accuracy from TF32 tensor cores. The
// tensor core reads 19 bits of each f32 operand, so one TF32 product loses
// the f32 result (on an RDB more than 3x the port's f32 tolerance, as
// tests/test_torch_rdb.py emulates it); each operand is split as
// hi = tf32(v), lo = tf32(v - hi) and three products hi*hi + lo*hi + hi*lo
// (lo*lo is below f32's rounding) give f32
// accuracy at a third of the 495 TFLOP/s TF32 rate, ~165 TFLOP/s: 2.5x the
// 67 TFLOP/s of plain FP32 FMAs, which is what bounded the direct kernel this
// replaced. tf32 wgmma takes K-major operands only and is k8 deep.
// - B: hi and lo are split on the host and stacked along N,
//   [cin/8][9][2][hi N | lo N][4], so B_lo is B_hi's descriptor + N*16 B.
// - A: the consumers load their register fragment of each tap from the
//   staged band, split it in registers (round to nearest, ties away, to 10
//   mantissa bits: the same bit arithmetic as the host packing) and issue
//   wgmma.m64nNk8.tf32 with A in registers, three per tap and tile into one
//   accumulator: A_hi B_hi + A_lo B_hi + A_hi B_lo. A thread's fragment of
//   tap (dy, dx) is band row lane/4 + dy of columns 2q + dx (+1), so the
//   three dx taps of one dy share four loaded columns: 8 loads and splits
//   serve 9 wgmmas. Two register sets alternate between (dy, tile) units,
//   and a set is rewritten only after wgmma.wait_group has retired the group
//   that read it. This keeps up to 122 registers a thread live, so the
//   kernel runs one block per SM (at two, ptxas serialises the wgmmas for
//   want of registers, C7511). The weights' bytes per stage double against
//   bf16 (hi and lo, 4 B each): 3 stages take 88 KB at N = 32, 143 KB at 64.
// What still bounds both routes, and what a faster one changes: see
// ops/cuda/rdb.py.
//
// Plain C interface, loaded with ctypes: the host function returns
// cudaGetLastError() after each launch (0 on success), or a negative code
// of its own (ssr_cuda_error_string names both). Launches go on the caller's
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
constexpr int TW = 32;                                  // output columns per block
constexpr int BAND_ROWS = TH + 2;                       // 10
constexpr int BAND_COLS = TW + 2;                       // 34
constexpr int COL_BYTES = BAND_ROWS * 16;               // 160: A's SBO
constexpr int PLANE_BYTES = BAND_COLS * COL_BYTES;      // 5440: A's LBO
constexpr int IN_STAGE_BYTES = 2 * PLANE_BYTES;         // 10880: one 32-byte k-step
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;                            // warpgroups, two m64 tiles each
constexpr int WG_THREADS = 128;
constexpr int WGMMA_THREADS = CONSUMERS * WG_THREADS + 32;  // + one producer warp
constexpr long long WAIT_LIMIT = 1LL << 35;             // cycles (~19 s) before a wait traps

// Input channels per stage (one wgmma k-step: k16 bf16, k8 tf32) and the
// packed weight bytes of one stage: 9 taps x 32 B of K x N rows, twice for
// f32 (hi and lo).
template <typename T> __host__ __device__ constexpr int stage_channels() {
  return 32 / sizeof(T);
}
template <typename T, int N> __host__ __device__ constexpr int w_stage_bytes() {
  return 9 * 32 * N * (std::is_same<T, float>::value ? 2 : 1);
}
template <typename T, int N> __host__ __device__ constexpr int conv_smem_bytes() {
  return STAGES * (IN_STAGE_BYTES + w_stage_bytes<T, N>()) + 2 * STAGES * 8;
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

// Spins until the barrier's phase with this parity has completed. A wait
// that outlasts WAIT_LIMIT traps, so a broken pipeline fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  while (true) {
    uint32_t done;
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
template <int R>
__device__ __forceinline__ void fence_acc(float (&acc)[2][R]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
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

// Shared-memory map of both kernels: [STAGES] bands, [STAGES] weight stages,
// then the full and empty barriers.
template <typename T, int N>
struct Ring {
  static constexpr int W_BYTES = w_stage_bytes<T, N>();
  uint8_t* s_in;   // [STAGES][2][34][10][16 B]
  uint8_t* s_w;    // [STAGES][W_BYTES]
  uint32_t full0;  // full[s] at full0 + 8s
  uint32_t empty0; // empty[s] at empty0 + 8s

  __device__ __forceinline__ explicit Ring(uint8_t* smem)
      : s_in(smem), s_w(smem + STAGES * IN_STAGE_BYTES),
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
      mbar_expect_tx(full, IN_STAGE_BYTES + W_BYTES);
      tma_load_5d(smem_u32(s_in + s * IN_STAGE_BYTES), band, full, 0, ty0 - 1, tx0 - 1, 2 * i, b);
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

// Epilogue of consumer warpgroup wg (m64 tiles 2wg and 2wg+1). Accumulator
// fragment of m64nN: warp q of the group holds M rows 16q + lane/4 (+8);
// with M = column*8 + row that is band row lane/4 of columns 2q (and 2q+1);
// registers 4j..4j+3 hold channels 8j + 2(lane%4) and +1 of those two pixels.
// buf is read only for the residual of launch 4; buf and out may alias.
template <typename T, int N>
__device__ __forceinline__ void store_band(const float (&acc)[2][N / 2],
                                           const float* __restrict__ bias, const T* buf, T* out,
                                           int b, int ty0, int tx0, int wg, int H, int W, int ctot,
                                           int out_stride, int out_off, int residual) {
  const int q = (threadIdx.x % WG_THREADS) / 32;
  const int lane = threadIdx.x % 32;
  const int gy = ty0 + lane / 4;
  if (gy >= H) return;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = tx0 + (2 * wg + t) * 8 + 2 * q + h;
      if (gx >= W) continue;
      const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int co = 8 * j + 2 * (lane % 4);
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
  extern __shared__ __align__(128) uint8_t smem[];  // TMA, no swizzle: 128 B
  const Ring<__nv_bfloat16, N> ring(smem);
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

  float acc[2][N / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int r = 0; r < N / 2; ++r) acc[t][r] = 0.f;

  const uint32_t in0 = smem_u32(ring.s_in) + wg * 2 * 8 * COL_BYTES;
  const uint32_t w0 = smem_u32(ring.s_w);
  const bool leader = threadIdx.x % WG_THREADS == 0;
  for (int i = 0; i < chunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(ring.full0 + 8 * s, (i / STAGES) & 1);
    const uint64_t da = smem_desc(in0 + s * IN_STAGE_BYTES, PLANE_BYTES, COL_BYTES);
    const uint64_t db = smem_desc(w0 + s * ring.W_BYTES, N * 16, 128);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t dbt = db + ((tap * 2 * N * 16) >> 4);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        Wgmma<N>::run(acc[t], da + (((t * 8 + dx) * COL_BYTES + dy * 16) >> 4), dbt);
    }
    wgmma_commit();
    // the group of chunk i-1 has retired: its stage may be refilled
    wgmma_wait<1>();
    if (i > 0 && leader) mbar_arrive(ring.empty0 + 8 * ((i - 1) % STAGES));
  }
  wgmma_wait<0>();
  store_band<__nv_bfloat16, N>(acc, bias, buf, out, b, ty0, tx0, wg, H, W, ctot, out_stride,
                               out_off, residual);
}

// One conv of the RDB for an 8 x 32 band and all N output channels, f32 by
// three TF32 products (see the head of this file).
template <int N>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
dense_conv3x3_tf32x3(const __grid_constant__ CUtensorMap band,
                     const float* __restrict__ w,  // [cin/8][9][2][hi N | lo N][4]
                     const float* __restrict__ bias,  // [N]
                     const float* buf,                // [B, H, W, ctot]
                     float* out,                      // [B, H, W, out_stride]
                     int H, int W, int ctot, int cin,
                     int out_stride, int out_off, int residual) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Ring<float, N> ring(smem);
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

  float acc[2][N / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int r = 0; r < N / 2; ++r) acc[t][r] = 0.f;

  // This thread's A fragment of tile t, tap (dy, dx): M row 16q + lane/4
  // (+8) is band row lane/4 + dy of column 16wg + 8t + 2q + dx (+1); K column
  // lane%4 (+4) is element lane%4 of channel plane 0 (1).
  const int q = (threadIdx.x % WG_THREADS) / 32;
  const int lane = threadIdx.x % 32;
  const float* a0 = reinterpret_cast<const float*>(
      ring.s_in + (16 * wg + 2 * q) * COL_BYTES + (lane / 4) * 16 + (lane % 4) * 4);
  const uint32_t w0 = smem_u32(ring.s_w);
  const bool leader = threadIdx.x % WG_THREADS == 0;
  uint32_t hi[2][8], lo[2][8];  // two register sets: [column c][plane p] at 2c + p
  fence_acc(acc);
  for (int i = 0; i < chunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(ring.full0 + 8 * s, (i / STAGES) & 1);
    const float* a_s = a0 + s * (IN_STAGE_BYTES / 4);
    const uint32_t w_s = w0 + s * ring.W_BYTES;
    // six units (dy, tile), one wgmma group each; set u % 2
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      const int dy = u / 2, t = u % 2, r = u % 2;
      // the group that read set r (two units back) retires; from the second
      // unit on, every group of stage i-1 has, so its stage may be refilled
      wgmma_wait<1>();
      if (u == 1 && i > 0 && leader) mbar_arrive(ring.empty0 + 8 * ((i - 1) % STAGES));
      const float* a = a_s + (t * 8 * COL_BYTES + dy * 16) / 4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float v = a[(p * PLANE_BYTES + c * COL_BYTES) / 4];
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
        // B of tap (dy, dx): 2 K halves x 2N rows x 16 B; lo starts N rows on
        const uint64_t dbh = smem_desc(w_s + (dy * 3 + dx) * 64 * N, 2 * N * 16, 128);
        const uint64_t dbl = dbh + ((N * 16) >> 4);
        WgmmaTf32<N>::run(acc[t], ah, dbh);
        WgmmaTf32<N>::run(acc[t], al, dbh);
        WgmmaTf32<N>::run(acc[t], ah, dbl);
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  store_band<float, N>(acc, bias, buf, out, b, ty0, tx0, wg, H, W, ctot, out_stride, out_off,
                       residual);
}

// Errors of the host code's own, beside CUDA's (which are >= 0).
constexpr int ERR_NO_DRIVER_ENTRY = -1;  // cuTensorMapEncodeTiled not found in libcuda
constexpr int ERR_TENSOR_MAP = -2;       // cuTensorMapEncodeTiled refused the map
constexpr int ERR_SHAPE = -3;            // nf or g not 32 or 64

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

template <typename T, int N>
using ConvKernel = void (*)(CUtensorMap, const T*, const float*, const T*, T*, int, int, int,
                            int, int, int, int);

template <typename T, int N>
constexpr ConvKernel<T, N> conv_kernel() {
  if constexpr (std::is_same<T, float>::value)
    return dense_conv3x3_tf32x3<N>;
  else
    return dense_conv3x3_wgmma<N>;
}

// Opts the kernel into its dynamic shared memory, once per device.
template <typename T, int N>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(conv_kernel<T, N>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             conv_smem_bytes<T, N>());
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int N>
int launch_conv(const CUtensorMap& map, const void* w, const float* bias, const T* buf, T* out,
                int B, int H, int W, int ctot, int cin, int out_stride, int out_off,
                int residual, cudaStream_t stream) {
  const cudaError_t err = allow_smem<T, N>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), 1, B);
  const ConvKernel<T, N> kernel = conv_kernel<T, N>();
  kernel<<<grid, WGMMA_THREADS, conv_smem_bytes<T, N>(), stream>>>(
      map, static_cast<const T*>(w), bias, buf, out, H, W, ctot, cin, out_stride, out_off,
      residual);
  return static_cast<int>(cudaGetLastError());
}

// The five launches of one RDB. buf holds x in channels [0, nf); w[k] is
// conv k's packed weight; bias is the five biases concatenated (f32,
// 4g + nf).
template <typename T>
int rdb_forward(T* buf, const void* const* w, const float* bias, T* out, int B, int H, int W,
                int nf, int g, cudaStream_t stream) {
  if ((nf != 32 && nf != 64) || (g != 32 && g != 64)) return ERR_SHAPE;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_DRIVER_ENTRY;
  const int ctot = nf + 4 * g;
  constexpr int E = sizeof(T);
  constexpr int GROUP = 16 / E;  // channels in one 16-byte core-matrix row
  // buf viewed as (GROUP channels, H, W, ctot/GROUP channel groups, B),
  // innermost first; the box is one stage's band: GROUP ch x 10 rows x
  // 34 columns x 2 groups
  const cuuint64_t dims[5] = {GROUP, (cuuint64_t)H, (cuuint64_t)W, (cuuint64_t)(ctot / GROUP),
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)W * ctot * E, (cuuint64_t)ctot * E, 16,
                                 (cuuint64_t)H * W * ctot * E};
  const cuuint32_t box[5] = {GROUP, BAND_ROWS, BAND_COLS, 2, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map;
  if (encode(&map, type, 5, buf, dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  for (int k = 0; k < 5; ++k) {
    const int cin = nf + k * g;
    const bool last = k == 4;
    const int cout = last ? nf : g;
    T* dst = last ? out : buf;
    const int stride = last ? nf : ctot, off = last ? 0 : cin;
    const int err = cout == 32
        ? launch_conv<T, 32>(map, w[k], bias + k * g, buf, dst, B, H, W, ctot, cin, stride, off,
                             last, stream)
        : launch_conv<T, 64>(map, w[k], bias + k * g, buf, dst, B, H, W, ctot, cin, stride, off,
                             last, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

int ssr_rdb_forward_f32(void* buf, const void* w0, const void* w1, const void* w2,
                        const void* w3, const void* w4, const void* bias, void* out,
                        int B, int H, int W, int nf, int g, void* stream) {
  const void* w[5] = {w0, w1, w2, w3, w4};
  return rdb_forward(static_cast<float*>(buf), w, static_cast<const float*>(bias),
                     static_cast<float*>(out), B, H, W, nf, g, static_cast<cudaStream_t>(stream));
}

int ssr_rdb_forward_bf16(void* buf, const void* w0, const void* w1, const void* w2,
                         const void* w3, const void* w4, const void* bias, void* out,
                         int B, int H, int W, int nf, int g, void* stream) {
  const void* w[5] = {w0, w1, w2, w3, w4};
  return rdb_forward(static_cast<__nv_bfloat16*>(buf), w, static_cast<const float*>(bias),
                     static_cast<__nv_bfloat16*>(out), B, H, W, nf, g,
                     static_cast<cudaStream_t>(stream));
}

const char* ssr_cuda_error_string(int code) {
  switch (code) {
    case ERR_NO_DRIVER_ENTRY: return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused the band's tensor map";
    case ERR_SHAPE:
      return "the rdb kernel (float32 and bfloat16 routes) takes nf and g of 32 or 64";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"

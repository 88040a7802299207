// ResidualDenseBlock of the RRDBNet trunk, for Hopper (sm_90a).
//
// Replaces satlas_sr_tpu/ops/pallas/rdb.py:129 rdb_pallas. One RDB is
//   x_{k+1} = lrelu_0.2(conv3x3_k(concat(x, x_1 .. x_k)))   for k = 0..3
//   out     = x + 0.2 * conv3x3_4(concat(x, x_1 .. x_4))
// over NHWC tensors, with nf = 64 feature and g = 32 growth channels at the
// flagship width.
//
// Both dtypes share the outer structure: the wrapper allocates one
// channels-last dense-concat buffer [B, H, W, nf + 4g] and copies x into
// channels [0, nf). Launch k reads channels [0, nf + k*g) and, for k < 4,
// writes its g output channels at [nf + k*g, nf + (k+1)*g) of the same
// buffer, so the concat is never materialised; launch 4 writes
// x + 0.2*conv to the output tensor. One block computes an 8-row x 32-column
// output band of one image for all of the launch's output channels (f32: 32
// per block, so conv5 takes two). The bias is f32 and is added in the
// epilogue, with LeakyReLU (launches 0-3) or the 0.2-scaled residual
// (launch 4); the result is rounded once to the tensor's type.
//
// float32 (dense_conv3x3_f32): a direct conv on CUDA cores, plain FP32 FMAs
// (no TF32). Input channels are staged 16 at a time into shared memory: the
// halo tile [16][10][34] (channel-major, so the 32 lanes of a warp read 32
// neighbouring columns without bank conflicts) and the weight slab
// [16][9][32] (a broadcast). Each thread keeps 4 rows x 8 output channels of
// accumulators. Zero padding is the bounds check of the staging load.
//
// bfloat16 (dense_conv3x3_wgmma): each conv is an implicit GEMM on the tensor
// cores, M = the band's 256 pixels, N = cout (32, or 64 for conv5),
// K = 9 taps x cin, accumulated in f32 by wgmma.m64nNk16.
// - A (pixels x channels) is never copied per tap. A TMA tiled load writes
//   the band with its halo, 10 rows x 34 columns x 16 channels, as
//   [channel group of 8][column][row][8 channels]: the tensor map views buf
//   as (8 ch, H, W, ctot/8, B), innermost first, and its out-of-bounds zero
//   fill, starting at row -1 and column -1, is the conv's zero padding. In
//   that order 8 consecutive M rows (8 rows of one column) are one 8 x 16 B
//   core matrix of wgmma's no-swizzle layout: an m64 tile is 8 rows x 8
//   columns, SBO is one column (160 B), LBO one channel-group plane
//   (5440 B), and tap (dy, dx) adds dy*16 + dx*160 bytes to the start
//   address, so all nine taps read the same staged band.
// - B (weights) is packed on the host (ops/cuda/rdb.py pack_weights) into the
//   exact shared-memory image the descriptor reads, [cin/16][9][2][N][8], and
//   moved by one 1-D bulk copy per stage.
// - A ring of 3 stages of (16 input channels, their weights), filled by one
//   producer warp (TMA + bulk copy, completed on the stage's mbarrier) while
//   two consumer warpgroups, each owning two m64 tiles (16 columns), run the
//   nine taps' wgmmas; a consumer frees a stage once the wgmma group that
//   read it has retired. Two blocks fit on an SM.
// - Epilogue in registers: bias, activation or residual, one rounding to
//   bf16, stored straight into the concat buffer's channel slice or out.
// What still bounds it, and what a faster one changes: see ops/cuda/rdb.py.
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

namespace {

constexpr int TH = 8;     // output rows per block
constexpr int TW = 32;    // output columns per block

// ----------------------------------------------------------------------------
// float32: direct conv on CUDA cores

constexpr int CO = 32;    // output channels per block
constexpr int CK = 16;    // input channels staged per step
constexpr int RPT = 4;    // output rows per thread
constexpr int COPT = 8;   // output channels per thread
constexpr int ROW_GROUPS = TH / RPT;                  // 2
constexpr int CO_GROUPS = CO / COPT;                  // 4
constexpr int NTHREADS = 32 * ROW_GROUPS * CO_GROUPS; // 256

// buf and out may be the same tensor (launches 0-3 write channels that the
// launch does not read), so neither is __restrict__.
__global__ void __launch_bounds__(NTHREADS)
dense_conv3x3_f32(const float* buf,                 // [B, H, W, ctot]
                  const float* __restrict__ w,      // [cout/CO, cin, 9, CO]
                  const float* __restrict__ bias,   // [cout]
                  float* out,                       // [B, H, W, out_stride]
                  int H, int W, int ctot, int cin,
                  int out_stride, int out_off, int residual) {
  __shared__ float s_in[CK][TH + 2][TW + 2];
  __shared__ __align__(16) float s_w[CK][9][CO];

  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int co_tile = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp % ROW_GROUPS;
  const int cg = warp / ROW_GROUPS;

  const float* img = buf + (size_t)b * H * W * ctot;
  const float* wt = w + (size_t)co_tile * cin * 9 * CO;

  float acc[RPT][COPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int o = 0; o < COPT; ++o) acc[r][o] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    for (int i = threadIdx.x; i < (TH + 2) * (TW + 2) * CK; i += NTHREADS) {
      const int c = i % CK;
      const int p = i / CK;
      const int px = p % (TW + 2);
      const int py = p / (TW + 2);
      const int gy = ty0 + py - 1;
      const int gx = tx0 + px - 1;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = img[((size_t)gy * W + gx) * ctot + c0 + c];
      s_in[c][py][px] = v;
    }
    const float* wc = wt + (size_t)c0 * 9 * CO;
    float* sw = &s_w[0][0][0];
    for (int i = threadIdx.x; i < CK * 9 * CO; i += NTHREADS) sw[i] = wc[i];
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float col[RPT + 2];
#pragma unroll
        for (int r = 0; r < RPT + 2; ++r) col[r] = s_in[c][rg * RPT + r][lane + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4* wp = reinterpret_cast<const float4*>(&s_w[c][dy * 3 + dx][cg * COPT]);
          const float4 wa = wp[0];
          const float4 wb = wp[1];
          const float wv[COPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int o = 0; o < COPT; ++o) acc[r][o] = fmaf(col[r + dy], wv[o], acc[r][o]);
        }
      }
    }
    __syncthreads();
  }

  const int gx = tx0 + lane;
  if (gx >= W) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gy = ty0 + rg * RPT + r;
    if (gy >= H) break;
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int o = 0; o < COPT; ++o) {
      const int co = co_tile * CO + cg * COPT + o;
      float v = acc[r][o] + bias[co];
      if (residual)
        v = 0.2f * v + buf[pix * ctot + co];
      else
        v = v >= 0.f ? v : 0.2f * v;
      out[pix * out_stride + out_off + co] = v;
    }
  }
}

// ----------------------------------------------------------------------------
// bfloat16: implicit GEMM on wgmma, fed by TMA and bulk copies

constexpr int BAND_ROWS = TH + 2;                       // 10
constexpr int BAND_COLS = TW + 2;                       // 34
constexpr int KC = 16;                                  // input channels per stage: one k16
constexpr int COL_BYTES = BAND_ROWS * 16;               // 160: A's SBO
constexpr int PLANE_BYTES = BAND_COLS * COL_BYTES;      // 5440: A's LBO
constexpr int IN_STAGE_BYTES = (KC / 8) * PLANE_BYTES;  // 10880
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;                            // warpgroups, two m64 tiles each
constexpr int WG_THREADS = 128;
constexpr int WGMMA_THREADS = CONSUMERS * WG_THREADS + 32;  // + one producer warp
constexpr long long WAIT_LIMIT = 1LL << 35;             // cycles (~19 s) before a wait traps

template <int N> __host__ __device__ constexpr int w_stage_bytes() { return 9 * KC * N * 2; }
template <int N> __host__ __device__ constexpr int wgmma_smem_bytes() {
  return STAGES * (IN_STAGE_BYTES + w_stage_bytes<N>()) + 2 * STAGES * 8;
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

// D[64 x N] += A[64 x 16] * B[16 x N], both K-major in shared memory.
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

// One conv of the RDB for an 8 x 32 band and all N output channels. `band`
// is the tensor map of buf (see rdb_forward_bf16); buf is read directly only
// for the residual of launch 4. buf and out may alias (launches 0-3).
template <int N>
__global__ void __launch_bounds__(WGMMA_THREADS, 2)
dense_conv3x3_wgmma(const __grid_constant__ CUtensorMap band,
                    const __nv_bfloat16* __restrict__ w,  // [cin/16][9][2][N][8]
                    const float* __restrict__ bias,       // [N]
                    const __nv_bfloat16* buf,              // [B, H, W, ctot]
                    __nv_bfloat16* out,                    // [B, H, W, out_stride]
                    int H, int W, int ctot, int cin,
                    int out_stride, int out_off, int residual) {
  constexpr int W_BYTES = w_stage_bytes<N>();
  extern __shared__ __align__(128) uint8_t smem[];  // TMA, no swizzle: 128 B
  uint8_t* s_in = smem;                               // [STAGES][2][34][10][8] bf16
  uint8_t* s_w = smem + STAGES * IN_STAGE_BYTES;      // [STAGES][9][2][N][8] bf16
  const uint32_t full0 = smem_u32(s_w + STAGES * W_BYTES);  // full[s] at full0 + 8s
  const uint32_t empty0 = full0 + STAGES * 8;               // empty[s] at empty0 + 8s

  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.z;
  const int chunks = cin / KC;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer warp: one lane keeps the ring full
    if (threadIdx.x % 32 == 0) {
      for (int i = 0; i < chunks; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, IN_STAGE_BYTES + W_BYTES);
        tma_load_5d(smem_u32(s_in + s * IN_STAGE_BYTES), &band, full,
                    0, ty0 - 1, tx0 - 1, i * (KC / 8), b);
        bulk_load(smem_u32(s_w + s * W_BYTES), w + (size_t)i * (W_BYTES / 2), W_BYTES, full);
      }
    }
    return;
  }

  // consumer warpgroup wg: m64 tiles 2wg and 2wg+1, i.e. band columns
  // [16wg, 16wg + 16)
  float acc[2][N / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int r = 0; r < N / 2; ++r) acc[t][r] = 0.f;

  const uint32_t in0 = smem_u32(s_in) + wg * 2 * 8 * COL_BYTES;
  const uint32_t w0 = smem_u32(s_w);
  const bool leader = threadIdx.x % WG_THREADS == 0;
  for (int i = 0; i < chunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    const uint64_t da = smem_desc(in0 + s * IN_STAGE_BYTES, PLANE_BYTES, COL_BYTES);
    const uint64_t db = smem_desc(w0 + s * W_BYTES, N * 16, 128);
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
    if (i > 0 && leader) mbar_arrive(empty0 + 8 * ((i - 1) % STAGES));
  }
  wgmma_wait<0>();

  // accumulator fragment of m64nN: warp q of the group holds M rows
  // 16q + lane/4 (+8); with M = column*8 + row that is band row lane/4 of
  // columns 2q (and 2q+1); registers 4j..4j+3 hold channels 8j + 2(lane%4)
  // and +1 of those two pixels
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
        if (residual) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(buf + pix * ctot + co));
          v0 = 0.2f * v0 + x.x;
          v1 = 0.2f * v1 + x.y;
        } else {
          v0 = v0 >= 0.f ? v0 : 0.2f * v0;
          v1 = v1 >= 0.f ? v1 : 0.2f * v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + pix * out_stride + out_off + co) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
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

// Opts the kernel into its dynamic shared memory, once per device.
template <int N>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(dense_conv3x3_wgmma<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wgmma_smem_bytes<N>());
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int N>
int launch_wgmma(const CUtensorMap& map, const void* w, const float* bias,
                 const __nv_bfloat16* buf, __nv_bfloat16* out, int B, int H, int W, int ctot,
                 int cin, int out_stride, int out_off, int residual, cudaStream_t stream) {
  const cudaError_t err = allow_smem<N>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), 1, B);
  dense_conv3x3_wgmma<N><<<grid, WGMMA_THREADS, wgmma_smem_bytes<N>(), stream>>>(
      map, static_cast<const __nv_bfloat16*>(w), bias, buf, out, H, W, ctot, cin, out_stride,
      out_off, residual);
  return static_cast<int>(cudaGetLastError());
}

// The five launches of one RDB. buf holds x in channels [0, nf); w[k] is
// conv k's packed weight; bias is the five biases concatenated (f32,
// 4g + nf).
int rdb_forward_f32(float* buf, const void* const* w, const float* bias, float* out, int B,
                    int H, int W, int nf, int g, cudaStream_t stream) {
  const int ctot = nf + 4 * g;
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  for (int k = 0; k < 5; ++k) {
    const int cin = nf + k * g;
    const bool last = k == 4;
    const int cout = last ? nf : g;
    const dim3 grid(tiles, cout / CO, B);
    dense_conv3x3_f32<<<grid, NTHREADS, 0, stream>>>(
        buf, static_cast<const float*>(w[k]), bias + k * g, last ? out : buf,
        H, W, ctot, cin, last ? nf : ctot, last ? 0 : cin, last ? 1 : 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int rdb_forward_bf16(__nv_bfloat16* buf, const void* const* w, const float* bias,
                     __nv_bfloat16* out, int B, int H, int W, int nf, int g,
                     cudaStream_t stream) {
  if ((nf != 32 && nf != 64) || (g != 32 && g != 64)) return ERR_SHAPE;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_DRIVER_ENTRY;
  const int ctot = nf + 4 * g;
  // buf viewed as (8 channels, H, W, ctot/8 channel groups, B), innermost
  // first; the box is one stage's band: 8 ch x 10 rows x 34 columns x 2 groups
  const cuuint64_t dims[5] = {8, (cuuint64_t)H, (cuuint64_t)W, (cuuint64_t)(ctot / 8),
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)W * ctot * 2, (cuuint64_t)ctot * 2, 16,
                                 (cuuint64_t)H * W * ctot * 2};
  const cuuint32_t box[5] = {8, BAND_ROWS, BAND_COLS, KC / 8, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, buf, dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  for (int k = 0; k < 5; ++k) {
    const int cin = nf + k * g;
    const bool last = k == 4;
    const int cout = last ? nf : g;
    __nv_bfloat16* dst = last ? out : buf;
    const int stride = last ? nf : ctot, off = last ? 0 : cin;
    const int err = cout == 32
        ? launch_wgmma<32>(map, w[k], bias + k * g, buf, dst, B, H, W, ctot, cin, stride, off,
                           last, stream)
        : launch_wgmma<64>(map, w[k], bias + k * g, buf, dst, B, H, W, ctot, cin, stride, off,
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
  return rdb_forward_f32(static_cast<float*>(buf), w, static_cast<const float*>(bias),
                         static_cast<float*>(out), B, H, W, nf, g,
                         static_cast<cudaStream_t>(stream));
}

int ssr_rdb_forward_bf16(void* buf, const void* w0, const void* w1, const void* w2,
                         const void* w3, const void* w4, const void* bias, void* out,
                         int B, int H, int W, int nf, int g, void* stream) {
  const void* w[5] = {w0, w1, w2, w3, w4};
  return rdb_forward_bf16(static_cast<__nv_bfloat16*>(buf), w, static_cast<const float*>(bias),
                          static_cast<__nv_bfloat16*>(out), B, H, W, nf, g,
                          static_cast<cudaStream_t>(stream));
}

const char* ssr_cuda_error_string(int code) {
  switch (code) {
    case ERR_NO_DRIVER_ENTRY: return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused the band's tensor map";
    case ERR_SHAPE: return "the bf16 rdb kernel takes nf and g of 32 or 64";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"

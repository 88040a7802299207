"""Probe of the tf32 wgmma layouts and of three 3xTF32 schemes, on one H100.

    python3 scripts/tf32_wgmma_probe.py

The design record behind the float32 route of satlas_sr_tpu_torch/csrc/rdb.cu
(dense_conv3x3_tf32x3). Builds a small CUDA source with nvcc (sm_90a) into
build/torch_kernels/ and checks, against numpy:
1. the FLOAT32 TMA box the kernel loads (4 channels per 16-byte row, 10 rows
   x 34 columns x 2 channel groups, zero fill from (-1, -1));
2. one wgmma.m64nNk8.tf32 (N = 32, 64, 128) with A in registers (the
   fragment map the kernel uses) and with A read through a descriptor, B
   K-major in the packed [2][N][4] layout.
Then times, on shared-memory-resident data with no loads from device memory,
one RDB stage's math (8 input channels, 9 taps, two m64 tiles for each of
two warpgroups) in three ways of forming hi*hi + lo*hi + hi*lo:
- RS-Kstack: A split in registers, three m64nNk8 into one accumulator (the
  kernel's choice);
- RS-Nstack: A split in registers, m64n(2N)k8 A_hi x [B_hi | B_lo] plus
  m64nNk8 A_lo x B_hi;
- SS-Kstack: A pre-split into hi and lo planes in shared memory, three
  m64nNk8 with both operands from descriptors.
Prints f32-equivalent TFLOP/s (one f32 product = three TF32 ones), the
registers and blocks per SM of each, and the card's name and power limit.
Exits non-zero if a layout check fails.
"""
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                   "torch_kernels")


def rs(n):
    r = n // 2
    accs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return f"""
template <> struct RS<{n}> {{
  __device__ __forceinline__ static void run(float (&d)[{r}], const uint32_t (&a)[4], uint64_t db) {{
    asm volatile("{{\\n .reg .pred p;\\n setp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{accs}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1;\\n}}\\n"
      : {outs}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }}
}};
"""


def ss(n):
    r = n // 2
    accs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return f"""
template <> struct SS<{n}> {{
  __device__ __forceinline__ static void run(float (&d)[{r}], uint64_t da, uint64_t db) {{
    asm volatile("{{\\n .reg .pred p;\\n setp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{accs}}}, %{r}, %{r + 1}, p, 1, 1;\\n}}\\n"
      : {outs}
      : "l"(da), "l"(db), "r"(1));
  }}
}};
"""


SRC = r"""
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  while (true) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 < 0) t0 = clock64(); else if (clock64() - t0 > (1LL << 33)) __trap();
  }
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile("cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4) : "memory");
}
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int P> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(P) : "memory");
}
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ uint32_t tf32_bits(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

template <int N> struct RS;
template <int N> struct SS;
@@WRAPPERS@@

__global__ void k_tma(const __grid_constant__ CUtensorMap map, float* out, int b, int y0, int x0, int cg) {
  __shared__ alignas(128) float s[2720];
  __shared__ alignas(8) uint64_t bar;
  const uint32_t bb = smem_u32(&bar);
  if (threadIdx.x == 0) {
    mbar_init(bb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bb, 10880);
    tma_load_5d(smem_u32(s), &map, bb, 0, y0 - 1, x0 - 1, cg, b);
  }
  mbar_wait(bb, 0);
  for (int i = threadIdx.x; i < 2720; i += blockDim.x) out[i] = s[i];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A [64][8] row-major; Bp packed [2][N][4]; D [64][N]. mode 0: A in registers; 1: A from smem
template <int N>
__global__ void k_mma(const float* A, const float* Bp, float* D, int mode) {
  __shared__ alignas(128) float sB[2 * N * 4];
  __shared__ alignas(128) float sA[64 * 8];
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * N * 4; i += 128) sB[i] = Bp[i];
  for (int i = tid; i < 512; i += 128) {
    const int m = i / 8, k = i % 8;  // core matrices: (k/4)*1024 + (m/8)*128 + (m%8)*16 + (k%4)*4 bytes
    sA[((k / 4) * 1024 + (m / 8) * 128 + (m % 8) * 16 + (k % 4) * 4) / 4] = __uint_as_float(tf32_bits(A[i]));
  }
  fence_async_smem();
  __syncthreads();
  const int q = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  uint32_t a[4] = {tf32_bits(A[(16 * q + g) * 8 + t]), tf32_bits(A[(16 * q + g + 8) * 8 + t]),
                   tf32_bits(A[(16 * q + g) * 8 + t + 4]), tf32_bits(A[(16 * q + g + 8) * 8 + t + 4])};
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint64_t db = smem_desc(smem_u32(sB), N * 16, 128);
  const uint64_t da = smem_desc(smem_u32(sA), 1024, 128);
  wgmma_fence();
  if (mode == 0) RS<N>::run(d, a, db); else SS<N>::run(d, da, db);
  wgmma_commit();
  wgmma_wait<0>();
  for (int j = 0; j < N / 8; ++j) {
    D[(16 * q + g) * N + 8 * j + 2 * t] = d[4 * j];
    D[(16 * q + g) * N + 8 * j + 2 * t + 1] = d[4 * j + 1];
    D[(16 * q + g + 8) * N + 8 * j + 2 * t] = d[4 * j + 2];
    D[(16 * q + g + 8) * N + 8 * j + 2 * t + 1] = d[4 * j + 3];
  }
}

constexpr int PLANE = 5440, COL = 160;

// compute-only microbench of one stage (8 input channels, 9 taps, 2 m64 tiles per warpgroup,
// 2 consumer warpgroups), smem resident. VAR 0: RS K-stack (3 x m64nNk8 per tap into one acc);
// VAR 1: RS N-stack (m64n2Nk8 hi x [Bhi|Blo] + m64nNk8 lo x Bhi); VAR 2: SS K-stack from split planes.
template <int N, int VAR>
__global__ void __launch_bounds__(256, 1) k_bench(int iters, float* sink) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* f = reinterpret_cast<float*>(smem);
  const int total = (2 * 10880 + 576 * N) / 4;
  for (int i = threadIdx.x; i < total; i += 256) f[i] = __uint_as_float(tf32_bits(1e-3f * ((i * 37) % 101 - 50)));
  fence_async_smem();
  __syncthreads();
  const uint32_t band = smem_u32(smem), band_lo = band + 10880, w = band + 2 * 10880;
  const int wg = threadIdx.x / 128, q = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  constexpr int R = VAR == 1 ? N : N / 2;
  float acc[2][R];
  float acl[2][VAR == 1 ? N / 2 : 1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[i][r] = 0.f;
#pragma unroll
    for (int r = 0; r < (VAR == 1 ? N / 2 : 1); ++r) acl[i][r] = 0.f;
  }
  uint32_t hi[2][8], lo[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) asm volatile("" : "+f"(acc[i][r]) :: "memory");
  }
  for (int it = 0; it < iters; ++it) {
    if constexpr (VAR == 2) {
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const uint64_t dbh = smem_desc(w + tap * 64 * N, 2 * N * 16, 128);
        const uint64_t dbl = smem_desc(w + tap * 64 * N + N * 16, 2 * N * 16, 128);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const uint32_t off = ((wg * 2 + tt) * 8 + dx) * COL + dy * 16;
          const uint64_t dah = smem_desc(band + off, PLANE, COL), dal = smem_desc(band_lo + off, PLANE, COL);
          SS<N>::run(acc[tt], dah, dbh);
          SS<N>::run(acc[tt], dal, dbh);
          SS<N>::run(acc[tt], dah, dbl);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
    } else {
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        const int dy = u / 2, tt = u % 2, s = u % 2;
        wgmma_wait<1>();
        const uint32_t base = ((wg * 2 + tt) * 8 + 2 * q) * COL + (g + dy) * 16 + t * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const float x = f[(base + p * PLANE + c * COL) / 4];
            const uint32_t h = tf32_bits(x);
            hi[s][2 * c + p] = h;
            lo[s][2 * c + p] = tf32_bits(x - __uint_as_float(h));
          }
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int tap = dy * 3 + dx;
          const uint32_t ah[4] = {hi[s][2 * dx], hi[s][2 * dx + 2], hi[s][2 * dx + 1], hi[s][2 * dx + 3]};
          const uint32_t al[4] = {lo[s][2 * dx], lo[s][2 * dx + 2], lo[s][2 * dx + 1], lo[s][2 * dx + 3]};
          const uint64_t dbh = smem_desc(w + tap * 64 * N, 2 * N * 16, 128);
          if constexpr (VAR == 0) {
            const uint64_t dbl = smem_desc(w + tap * 64 * N + N * 16, 2 * N * 16, 128);
            RS<N>::run(acc[tt], ah, dbh);
            RS<N>::run(acc[tt], al, dbh);
            RS<N>::run(acc[tt], ah, dbl);
          } else {
            RS<2 * N>::run(acc[tt], ah, dbh);
            RS<N>::run(acl[tt], al, dbh);
          }
        }
        wgmma_commit();
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) asm volatile("" : "+f"(acc[i][r]) :: "memory");
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) sum += acc[i][r];
#pragma unroll
    for (int r = 0; r < (VAR == 1 ? N / 2 : 1); ++r) sum += acl[i][r];
  }
  sink[blockIdx.x * 256 + threadIdx.x] = sum;
}

template <int N, int VAR> int bench_one(int blocks, int iters, float* sink, float* ms, int* regs, int* occ) {
  const int smem = 2 * 10880 + 576 * N;
  cudaFuncSetAttribute(k_bench<N, VAR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, k_bench<N, VAR>);
  *regs = attr.numRegs;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, k_bench<N, VAR>, 256, smem);
  k_bench<N, VAR><<<blocks, 256, smem>>>(2, sink);
  cudaEvent_t a, b;
  cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  k_bench<N, VAR><<<blocks, 256, smem>>>(iters, sink);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  cudaEventElapsedTime(ms, a, b);
  return (int)cudaDeviceSynchronize();
}
extern "C" {
int probe_tma(float* buf, float* out, int B, int H, int W, int C, int b, int y0, int x0, int cg) {
  void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  auto enc = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  if (!enc) return -1;
  const cuuint64_t dims[5] = {4, (cuuint64_t)H, (cuuint64_t)W, (cuuint64_t)(C / 4), (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)W * C * 4, (cuuint64_t)C * 4, 16, (cuuint64_t)H * W * C * 4};
  const cuuint32_t box[5] = {4, 10, 34, 2, 1};
  const cuuint32_t es[5] = {1, 1, 1, 1, 1};
  CUtensorMap map;
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, buf, dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -2;
  k_tma<<<1, 32>>>(map, out, b, y0, x0, cg);
  return (int)cudaDeviceSynchronize();
}
int probe_mma(int n, const float* A, const float* Bp, float* D, int mode) {
  if (n == 32) k_mma<32><<<1, 128>>>(A, Bp, D, mode);
  else if (n == 64) k_mma<64><<<1, 128>>>(A, Bp, D, mode);
  else k_mma<128><<<1, 128>>>(A, Bp, D, mode);
  return (int)cudaDeviceSynchronize();
}
int probe_bench(int n, int var, int blocks, int iters, float* sink, float* ms, int* regs, int* occ) {
  if (n == 32 && var == 0) return bench_one<32, 0>(blocks, iters, sink, ms, regs, occ);
  if (n == 32 && var == 1) return bench_one<32, 1>(blocks, iters, sink, ms, regs, occ);
  if (n == 32 && var == 2) return bench_one<32, 2>(blocks, iters, sink, ms, regs, occ);
  if (n == 64 && var == 0) return bench_one<64, 0>(blocks, iters, sink, ms, regs, occ);
  if (n == 64 && var == 1) return bench_one<64, 1>(blocks, iters, sink, ms, regs, occ);
  if (n == 64 && var == 2) return bench_one<64, 2>(blocks, iters, sink, ms, regs, occ);
  return -9;
}
}
"""


def tf32(x):
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def main():
    src = SRC.replace("@@WRAPPERS@@", "".join(rs(n) + ss(n) for n in (32, 64, 128)))
    from torch.utils.cpp_extension import CUDA_HOME

    if not torch.cuda.is_available() or not CUDA_HOME:
        print("tf32_wgmma_probe: needs an NVIDIA card and the CUDA toolkit", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "tf32_wgmma_probe.cu")
    so = os.path.join(OUT, "libtf32_wgmma_probe.so")
    open(cu, "w").write(src)
    t0 = time.time()
    p = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, cu],
                       capture_output=True, text=True)
    print(f"nvcc rc {p.returncode} in {time.time() - t0:.1f}s")
    for line in (p.stdout + p.stderr).splitlines():
        if "error" in line or "k_bench" in line or "Used" in line or "warn" in line.lower() or "spill" in line:
            print(line)
    if p.returncode:
        print(p.stdout + p.stderr)
        return 1
    lib = ctypes.CDLL(so)
    for f in (lib.probe_tma, lib.probe_mma, lib.probe_bench):
        f.restype = ctypes.c_int
    lib.probe_tma.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
    lib.probe_mma.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.probe_bench.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    rng = np.random.RandomState(0)
    ok = True
    # 1. TMA f32 box
    Bn, H, W, C = 2, 12, 20, 48
    buf = rng.randn(Bn, H, W, C).astype(np.float32)
    pad = np.zeros((Bn, H + 20, W + 40, C), np.float32)
    pad[:, 1:H + 1, 1:W + 1] = buf
    dbuf = torch.from_numpy(buf).cuda()
    for b, y0, x0, cg in [(0, 0, 0, 0), (1, 8, 0, 4), (1, 0, 0, 10)]:
        out = torch.zeros(2720, device="cuda")
        rc = lib.probe_tma(dbuf.data_ptr(), out.data_ptr(), Bn, H, W, C, b, y0, x0, cg)
        want = pad[b, y0:y0 + 10, x0:x0 + 34, 4 * cg:4 * cg + 8].reshape(10, 34, 2, 4).transpose(2, 1, 0, 3)
        good = rc == 0 and np.array_equal(out.cpu().numpy().reshape(2, 34, 10, 4), want)
        ok &= good
        print(f"tma box b={b} y0={y0} x0={x0} cg={cg}: rc {rc} {'ok' if good else 'FAIL'}")
    # 2. one wgmma, A regs / smem
    for n in (32, 64, 128):
        A = rng.randn(64, 8).astype(np.float32)
        Bm = rng.randn(n, 8).astype(np.float32)  # B[n][k]
        Bp = tf32(Bm).reshape(n, 2, 4).transpose(1, 0, 2).copy()  # [2][N][4]
        want = tf32(A).astype(np.float64) @ tf32(Bm).astype(np.float64).T
        for mode in (0, 1):
            D = torch.zeros(64, n, device="cuda")
            dA, dB = torch.from_numpy(A).cuda(), torch.from_numpy(Bp).cuda()
            rc = lib.probe_mma(n, dA.data_ptr(), dB.data_ptr(), D.data_ptr(), mode)
            err = np.abs(D.cpu().numpy() - want).max()
            good = rc == 0 and err < 1e-4
            ok &= good
            print(f"wgmma m64n{n}k8 tf32 {'RS' if mode == 0 else 'SS'}: rc {rc} max err {err:.3e} {'ok' if good else 'FAIL'}")
    # 3. bench
    sink = torch.zeros(132 * 8 * 256, device="cuda")
    for n in (32, 64):
        for var in (0, 1, 2):
            ms, regs, occ = ctypes.c_float(), ctypes.c_int(), ctypes.c_int()
            blocks, iters = 132 * 4, 200
            rc = lib.probe_bench(n, var, blocks, iters, sink.data_ptr(), ctypes.byref(ms),
                                 ctypes.byref(regs), ctypes.byref(occ))
            f32flops = blocks * 2 * iters * 9 * 2 * 64 * n * 8 * 2
            print(f"bench N={n} var={['RS-Kstack', 'RS-Nstack', 'SS-Kstack'][var]}: rc {rc} {ms.value:.3f} ms, "
                  f"regs {regs.value}, blocks/SM {occ.value}, f32-equiv {f32flops / ms.value / 1e9:.1f} TFLOP/s, "
                  f"tf32 tensor {3 * f32flops / ms.value / 1e9:.1f} TFLOP/s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print("PROBE", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

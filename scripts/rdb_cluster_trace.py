"""Where one call of the cluster RDB kernel spends its time, on one H100.

    python3 scripts/rdb_cluster_trace.py [--variants as_is,fence_all,ring4,ring8]
                                         [--shapes 1x8,1x16,8x16]

A design record of satlas_sr_tpu_torch/csrc/rdb.cu's rdb_cluster_wgmma (the
bf16 RDB in one launch on a thread-block cluster). Builds copies of rdb.cu
with nvcc (sm_90a) into build/torch_kernels/trace/, each with clock64 stamps
that thread 0 of every block writes at the kernel's phases (set-up, x, and
for each conv its main loop, its epilogue with the halo copies, and the
cluster barrier after it) and globaltimer stamps at entry and exit. Variants
change one thing of the copy:
- as_is: the kernel as committed;
- fence_all: the proxy fences without a state space (fence.proxy.async);
- ring4, ring8: a weight ring of 4 or 8 stages at either band width (the
  kernel has 8 at TW 8, where each warpgroup reads every other stage, and 4
  at TW 16);
- no_mma, no_load: without the wgmmas, or without the weight loads (times
  only: the output is wrong and is not checked).
For each variant and each shape BxTW (x [B, 32, 32, 64], band width TW) it
prints the median microseconds of each phase over the blocks, their sums,
the kernel's wall time from the first block's entry to the last block's
exit, the time of one call in a CUDA graph, and (but for no_mma, no_load)
bf16_branch_err against the plain version as chip_smoke.py reads it.
Imports torch, numpy and the port only.
"""
import argparse
import ctypes
import math
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SLOTS = 24  # stamps a block: 0 entry, 1 set-up, 2 x, 3 + 3k, 4 + 3k, 5 + 3k conv k, 22-23 ns
STAMP = ("{ if (threadIdx.x == 0) { g_trace[(blockIdx.y * gridDim.x + blockIdx.x) * %d + (%%s)] "
         "= clock64(); } }" % SLOTS)
NS = ("{ if (threadIdx.x == 0) { unsigned long long t; asm volatile(\"mov.u64 %%0, "
      "%%%%globaltimer;\" : \"=l\"(t)); g_trace[(blockIdx.y * gridDim.x + blockIdx.x) * "
      + str(SLOTS) + " + %s] = (long long)t; } }")
# (anchor, code, after the anchor?) in csrc/rdb.cu
STAMPS = [
    ("namespace {\n", "__device__ long long g_trace[4096 * %d];\n" % SLOTS, True),
    ("  const bool producer = wg == CONSUMERS && threadIdx.x % 32 == 0;\n",
     STAMP % "0" + "\n" + NS % "22" + "\n", True),
    ("  cluster_start();      // every block's buffers are zero and barriers set up\n",
     STAMP % "1" + "\n", True),
    ("  mbar_wait(blk.xbar, 0);\n", STAMP % "2" + "\n", True),
    ("  wgmma_wait<0>();\n  blk.release(last % S::STAGES);\n", STAMP % "3 + 3 * k" + "\n", True),
    ("    cluster_conv<C_G, TW>(blk, k, gi, out, cat, wg);\n", STAMP % "4 + 3 * k" + "\n", True),
    ("    blk.conv_done(k);  // conv k's channels, halos included, are in place everywhere\n",
     STAMP % "5 + 3 * k" + "\n", True),
    ("  cluster_conv<C_NF, TW>(blk, 4, gi, out, cat, wg);\n",
     STAMP % "16" + "\n" + STAMP % "17" + "\n" + NS % "23" + "\n", True),
]
VARIANTS = {
    "as_is": [],
    "fence_all": [('"fence.proxy.async.shared::cta;\\n"', '"fence.proxy.async;\\n"')],
    "ring4": [("  static constexpr int STAGES = KSPLIT ? 8 : 4;", "  static constexpr int STAGES = 4;")],
    "ring8": [("  static constexpr int STAGES = KSPLIT ? 8 : 4;", "  static constexpr int STAGES = 8;")],
    "no_mma": [("      Wgmma<N>::run(acc, ", "      if (0) Wgmma<N>::run(acc, ")],
    "no_load": [("    mbar_expect_tx(full0 + 8 * s, wb);\n    bulk_load(",
                 "    mbar_arrive(full0 + 8 * s);\n    if (0) bulk_load(")],
}
PHASES = ["set-up", "x"] + [f"conv{k + 1} {p}" for k in range(5)
                            for p in ("main", "epilogue", "barrier")]


def patched(variant: str) -> str:
    from satlas_sr_tpu_torch.ops.cuda.build import CSRC_DIR

    src = (CSRC_DIR / "rdb.cu").read_text()
    for anchor, code, after in STAMPS:
        if anchor not in src:
            raise SystemExit(f"rdb.cu has changed: no anchor {anchor!r}; update STAMPS")
        src = src.replace(anchor, anchor + code if after else code + anchor, 1)
    for a, b in VARIANTS[variant]:
        if a not in src:
            raise SystemExit(f"rdb.cu has changed: variant {variant} finds no {a!r}")
        src = src.replace(a, b)
    return src + ('\nextern "C" int ssr_trace_copy(void* dst, int n) '
                  '{ return (int)cudaMemcpyFromSymbol(dst, g_trace, n * 8); }\n')


def build(variants) -> dict:
    """Every variant's library, compiled in parallel."""
    from satlas_sr_tpu_torch.ops.cuda.build import BUILD_DIR, NVCC_FLAGS, nvcc

    out = BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        cu, lib = out / f"rdb_{v}.cu", out / f"librdb_{v}.so"
        cu.write_text(patched(v))
        procs[v] = (lib, subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for v, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {v}:\n{log[-4000:]}")
        libs[v] = str(lib)
    return libs


def graph_ms(fn, iters: int = 20, reps: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default="as_is,fence_all,ring4,ring8")
    parser.add_argument("--shapes", default="1x8,1x16,8x16")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("rdb_cluster_trace: needs an NVIDIA card", file=sys.stderr)
        return 1
    from satlas_sr_tpu_torch.ops.cuda import build as kbuild
    from satlas_sr_tpu_torch.ops.cuda import rdb as R

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    variants = args.variants.split(",")
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]
    libs = build(variants)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    nf, g = 64, 32
    kernels, biases = [], []
    for k in range(5):
        cin, cout = nf + k * g, (g if k < 4 else nf)
        kernels.append((torch.randn(cout, cin, 3, 3, generator=gen) * math.sqrt(2 / (9 * cin)))
                       .to(dev).bfloat16())
        biases.append((torch.randn(cout, generator=gen) * 0.01).to(dev))
    packed = R.pack_weights(kernels, biases, nf, g, torch.bfloat16)
    c16 = R.point_two(torch.bfloat16)
    for v in variants:
        kbuild._libs["rdb"] = ctypes.CDLL(libs[v])
        R._library.cache_clear()
        lib = kbuild._libs["rdb"]
        lib.ssr_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for b, tw in shapes:
            route = R.Route("cluster", tw)
            x = torch.randn(b, 32, 32, nf, generator=gen).to(dev).bfloat16()
            for _ in range(6):
                got = R._launch(x, packed, nf, g, route=route)
            torch.cuda.synchronize()
            blocks = b * (32 // 8) * (32 // tw)
            t = np.zeros(blocks * SLOTS, np.int64)
            if lib.ssr_trace_copy(t.ctypes.data, blocks * SLOTS):
                raise SystemExit("cudaMemcpyFromSymbol failed")
            t = t.reshape(blocks, SLOTS)
            ns = t[:, 23] - t[:, 22]
            ghz = np.mean(t[:, 17] - t[:, 0]) / np.mean(ns)
            us = np.median(np.diff(t[:, :18], axis=1), axis=0) / ghz / 1e3
            main = sum(us[2 + 3 * k] for k in range(5))
            epi = sum(us[3 + 3 * k] for k in range(5))
            bar = sum(us[4 + 3 * k] for k in range(4))
            ms = graph_ms(lambda: R._launch(x, packed, nf, g, route=route))
            check = ""
            if not v.startswith("no_"):
                want = R.rdb_reference(x.float(), [k.float() for k in kernels], biases, nf, g,
                                       c=c16)
                excess = ((got.float() - want).abs() - 2.0 ** -8 * want.abs()).clamp(min=0).max()
                check = f", bf16_branch_err {(excess / (want - x.float()).abs().max()).item():.2e}"
            wall = (t[:, 23].max() - t[:, 22].min()) / 1e3
            print(f"{v} x [{b}, 32, 32, {nf}] TW {tw}: wall {wall:.2f} us, "
                  f"CUDA graph {ms:.4f} ms{check}; SM clock {ghz:.2f} GHz; sums: main loops "
                  f"{main:.2f}, epilogues {epi:.2f}, barriers {bar:.2f}, set-up {us[0]:.2f}, x "
                  f"{us[1]:.2f} us")
            print("  median us: " + ", ".join(f"{n} {u:.2f}" for n, u in zip(PHASES, us)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

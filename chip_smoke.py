#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (satlas_sr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--kernels-only]

Phases, in order; any failure exits non-zero:
1. the card's name and power limit; build the port's CUDA source (rdb.cu:
   wgmma/TMA kernels, bfloat16 and float32 by three TF32 products) and
   print ptxas's register, shared memory and spill report.
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (rdb: x [64, 32, 32, 64], nf=64, g=32, weights at
   Kaiming fan-in scale so the conv branch is as large as x): float32 with
   TF32 off (atol 1e-4, rtol 1e-4) and bfloat16 against the plain version in
   float32 on the same bf16-cast inputs (`bf16_branch_err` <= 3e-2: the
   error beyond the bf16 output's own rounding, over the peak of the conv
   branch out - x), each for one call and for one RRDB (three calls and the
   0.2 outer residual, which catches offsets that differ between calls);
   times of the kernel, the plain version and one cuDNN yardstick (the same
   five convs as F.conv2d), and the bound.
3. the main path: GT-free esrgan_8S2 inference at full width (24 input
   channels, nf 64, 23 blocks, g 32, x4) with seeded random weights saved as
   a reference .pth, over a synthetic tree of 128 chips, through
   satlas_sr_tpu_torch.infer.run_inference, once in float32 and once in
   bfloat16. Kernel launch counts are zeroed just before each run and read
   just after; every sr.png must be 128x128x3 uint8; the float32 generator
   through the kernel must match the plain version within atol 1e-3 on one
   batch; bf16-vs-f32 output PSNR must be >= 30 dB.
4. one JSON line of kernel records, the card line, and the result line.

Exits non-zero, printing no result, when CUDA is not available or the port
is not beside this script. Everything is made from --seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

NF, G, BATCH, HW = 64, 32, 64, 32
N_CHIPS, N_FRAMES, N_LR = 128, 12, 8
NUM_BLOCK, IN_CH = 23, 24
RDBS_PER_FORWARD = NUM_BLOCK * 3
# H100 SXM, dense: bf16 and TF32 tensor cores; float32 runs as three TF32
# products per f32 product. FP32_FMA_PEAK is the CUDA cores' f32 rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
PRODUCTS = {torch.bfloat16: 1, torch.float32: 3}
FP32_FMA_PEAK = 67e12
PEAK_BYTES = 3.35e12


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def tf32_off():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rdb_bound_ms(dtype: torch.dtype, b: int):
    """Least time for one RDB call: each input and output moved once, or the
    route's tensor-core FLOPs at the card's peak for them (three TF32
    products per f32 FLOP), whichever is larger. Also returns the f32 FLOPs."""
    elt = torch.tensor([], dtype=dtype).element_size()
    macs_per_px = sum((NF + k * G) * (G if k < 4 else NF) * 9 for k in range(5))
    flops = 2 * b * HW * HW * macs_per_px
    nbytes = 2 * b * HW * HW * NF * elt + macs_per_px * elt + (4 * G + NF) * 4
    t_ops, t_bytes = PRODUCTS[dtype] * flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def allowance_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| as a share of the f32 check's allowance
    1e-4 + 1e-4 |want| (torch.allclose passes at <= 1)."""
    return ((got - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()


def bf16_branch_err(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    """Error of a bf16 RDB output against its f32 reference, relative to the
    conv branch: max(|got - want| - 2^-8 |want|, 0) / max |want - x|.

    2^-8 |want| covers rounding the output to bf16 (at most 2^-9 relative),
    which on its own reaches ~1% of the branch where |x| is large. A kernel
    that returned x, or dropped a few input channels of one conv, reads
    0.09 to 1 with the weights of phase_kernels; a right one ~1e-3.
    """
    excess = ((got - want).abs() - 2.0 ** -8 * want.abs()).clamp(min=0).max()
    return (excess / (want - x).abs().max()).item()


def phase_kernels(seed: int) -> dict:
    import torch.nn.functional as F

    from satlas_sr_tpu_torch.ops.cuda.rdb import pack_weights, rdb, rdb_reference

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(BATCH, HW, HW, NF, generator=gen).to(dev)
    kernels, biases = [], []
    for k in range(5):
        cin, cout = NF + k * G, (G if k < 4 else NF)
        kernels.append((torch.randn(cout, cin, 3, 3, generator=gen) * math.sqrt(2 / (9 * cin))).to(dev))
        biases.append((torch.randn(cout, generator=gen) * 0.01).to(dev))
    results = {}
    with torch.no_grad(), tf32_off():
        # float32: three TF32 products in the kernel, TF32 off in the plain version
        packed = pack_weights(kernels, biases, NF, G, torch.float32)
        got = rdb(x, kernels, biases, NF, G, packed=packed)
        want = rdb_reference(x, kernels, biases, NF, G)
        torch.cuda.synchronize()
        err32 = (got - want).abs().max().item()
        share32 = allowance_share(got, want)
        branch = (want - x).abs().max().item()
        ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
        print(f"rdb f32: max_abs_err {err32:.3e}, {share32:.3f} of the allowance (atol 1e-4, "
              f"rtol 1e-4; conv branch peak {branch:.3f}, max|ref| {want.abs().max().item():.3f}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("rdb f32 kernel disagrees with the plain version")

        # float32 chain: one RRDB, three kernel calls on each other's outputs
        chain = [[(torch.randn(*k.shape, generator=gen) * math.sqrt(2 / (9 * k.shape[1]))).to(dev)
                  for k in kernels] for _ in range(3)]
        h = x
        for kk in chain:
            h = rdb(h, kk, biases, NF, G, packed=pack_weights(kk, biases, NF, G, torch.float32))
        got_c = h * 0.2 + x
        h = x
        for kk in chain:
            h = rdb_reference(h, kk, biases, NF, G)
        want_c = h * 0.2 + x
        torch.cuda.synchronize()
        err32c = (got_c - want_c).abs().max().item()
        share32c = allowance_share(got_c, want_c)
        ok = torch.allclose(got_c, want_c, atol=1e-4, rtol=1e-4)
        print(f"rrdb f32 chain (3 calls): max_abs_err {err32c:.3e}, {share32c:.3f} of the "
              f"allowance (atol 1e-4, rtol 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("rdb f32 kernel chain disagrees with the plain chain")

        # bfloat16: against the plain version in f32 on the same bf16-cast inputs
        xb, kb = x.bfloat16(), [k.bfloat16() for k in kernels]
        packed_b = pack_weights(kb, biases, NF, G, torch.bfloat16)
        got_b = rdb(xb, kb, biases, NF, G, packed=packed_b).float()
        want_b = rdb_reference(xb.float(), [k.float() for k in kb], biases, NF, G)
        torch.cuda.synchronize()
        err16 = (got_b - want_b).abs().max().item()
        rel16 = bf16_branch_err(got_b, want_b, xb.float())
        print(f"rdb bf16: max_abs_err {err16:.3e}, bf16_branch_err {rel16:.3e} (bound 3e-2) "
              f"{'ok' if rel16 <= 3e-2 else 'FAIL'}")
        if not rel16 <= 3e-2:
            raise AssertionError("rdb bf16 kernel disagrees with the plain version")

        # bfloat16 chain: one RRDB, three kernel calls on each other's outputs
        chain = [[(torch.randn(*k.shape, generator=gen) * math.sqrt(2 / (9 * k.shape[1])))
                  .to(dev).bfloat16() for k in kernels] for _ in range(3)]
        h = xb
        for kk in chain:
            h = rdb(h, kk, biases, NF, G, packed=pack_weights(kk, biases, NF, G, torch.bfloat16))
        got_c = (h * 0.2 + xb).float()
        h = xb.float()
        for kk in chain:
            h = rdb_reference(h, [k.float() for k in kk], biases, NF, G)
        want_c = h * 0.2 + xb.float()
        torch.cuda.synchronize()
        relc = bf16_branch_err(got_c, want_c, xb.float())
        print(f"rrdb bf16 chain (3 calls): max_abs_err {(got_c - want_c).abs().max().item():.3e}, "
              f"bf16_branch_err {relc:.3e} (bound 3e-2) {'ok' if relc <= 3e-2 else 'FAIL'}")
        if not relc <= 3e-2:
            raise AssertionError("rdb bf16 kernel chain disagrees with the plain chain")

        checks = {"bf16": dict(max_abs_err=err16, bf16_branch_err=rel16,
                               chain_bf16_branch_err=relc),
                  "f32": dict(max_abs_err=err32, allowance_share=share32,
                              chain_max_abs_err=err32c, chain_allowance_share=share32c)}
        for dtype, xx, kk, pk in ((torch.bfloat16, xb, kb, packed_b),
                                  (torch.float32, x, kernels, packed)):
            bb = [b.to(dtype) for b in biases]
            # yardstick: the same five convs through cuDNN, on ready-made
            # dense-concat inputs (no concat or activation)
            feats = [torch.randn(BATCH, NF + k * G, HW, HW, device=dev, dtype=dtype)
                     .contiguous(memory_format=torch.channels_last) for k in range(5)]
            kcl = [k.contiguous(memory_format=torch.channels_last) for k in kk]
            lib = lambda: [F.conv2d(feats[k], kcl[k], bb[k], padding=1) for k in range(5)]
            ms = time_ms(lambda: rdb(xx, kk, biases, NF, G, packed=pk))
            plain_ms = time_ms(lambda: rdb_reference(xx, kk, biases, NF, G))
            library_ms = time_ms(lib)
            bound_ms, bound_by, flops = rdb_bound_ms(dtype, BATCH)
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            extra = ({"fp32_fma_bound_ms": 1e3 * flops / FP32_FMA_PEAK}
                     if dtype == torch.float32 else {})
            print(f"rdb {name} B={BATCH}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                  f"plain {plain_ms:.4f} ms, cuDNN five convs {library_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%)"
                  + "".join(f", {k} {v:.4f} ms ({100 * v / ms:.1f}%)" for k, v in extra.items()))
            results[name] = dict(**checks[name], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=library_ms, **extra)
    return results


def make_tree(root: str, rng: np.random.RandomState) -> None:
    from satlas_sr_tpu_torch.utils.imgio import write_png

    for i in range(N_CHIPS):
        data = (rng.rand(N_FRAMES * 32, 32, 3) * 254 + 1).astype(np.uint8)
        if i % 5 == 0:  # one black frame: the good-first frame policy skips it
            data[32:40] = 0
        write_png(os.path.join(root, f"chip{i:04d}", "tci.png"), data)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


@contextlib.contextmanager
def plain_trunk():
    """Run the trunk through the plain version (a comparison, not the product path)."""
    from satlas_sr_tpu_torch.archs import rrdbnet
    from satlas_sr_tpu_torch.ops.cuda.rdb import rdb_reference

    orig = rrdbnet.rdb
    rrdbnet.rdb = lambda x, k, b, nf, g, packed=None: rdb_reference(x, k, b, nf, g)
    try:
        yield
    finally:
        rrdbnet.rdb = orig


def profile_forwards(model, x: torch.Tensor, fwd_ms: float, n: int = 2, top: int = 8) -> None:
    """One torch.profiler window over n forwards: device kernels by total
    time, and the device's idle share (1 - union of kernel intervals over the
    span of the trace). The profiler slows the host, so the share is also
    given against fwd_ms, the unprofiled forward's time by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), tf32_off():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model(x)
            torch.cuda.synchronize()
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profiler: key_averages() shows no device time on this machine")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events))
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    total = sum(t for t, _ in by_name.values())
    print(f"profiler, {n} {str(x.dtype)[6:]} forwards of batch {x.shape[0]}: "
          f"window {window / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle share {1 - busy / window:.4f}; against the "
          f"unprofiled forward ({fwd_ms:.3f} ms) {1 - busy / 1e3 / n / fwd_ms:.4f}; "
          f"top device kernels by total time:")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t / 1e3 / n:9.3f} ms/forward {100 * t / total:5.1f}%  {c // n:4d} launches/forward  "
              f"{name[:90]}")


def phase_main_path(seed: int, work: str, card: str) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.infer import run_inference
    from satlas_sr_tpu_torch.inference import InferenceEngine
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.utils.imgio import read_png, write_png
    from satlas_sr_tpu_torch.utils.infer_utils import DECODE_THREADS, format_s2naip_batch
    from satlas_sr_tpu_torch.utils.torch_io import load_torch_state_dict, save_torch_state_dict

    net = dict(num_in_ch=IN_CH, num_out_ch=3, num_feat=NF, num_block=NUM_BLOCK, num_grow_ch=G)
    weights = os.path.join(work, "esrgan_8S2_seeded.pth")
    save_torch_state_dict(weights, RRDBNet(scale=4, seed=seed, device="cpu", **net).state_dict(),
                          param_key="params_ema")
    data_dir = os.path.join(work, "sentinel2")
    make_tree(data_dir, np.random.RandomState(seed))
    n_batches = -(-N_CHIPS // BATCH)

    launches, outs = {}, {}
    for dtype in ("float32", "bfloat16"):
        opt = {"data_dir": data_dir, "save_path": os.path.join(work, f"out_{dtype}"),
               "n_lr_images": N_LR, "scale": 4, "batch_size": BATCH, "compute_dtype": dtype,
               "matmul_precision": "highest", "network_g": {"type": "SSR_RRDBNet", **net},
               "path": {"pretrain_network_g": weights, "param_key_g": "params_ema"}}
        rdb_mod.LAUNCHES = 0
        t0 = time.time()
        n = run_inference(opt, device="cuda")
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches[dtype] = rdb_mod.LAUNCHES
        print(f"main path {dtype}: {n} chips in {dt:.3f} s end to end ({n / dt:.2f} img/s, "
              f"first call's packing and PNG IO included); rdb launches {launches[dtype]} "
              f"(expected {RDBS_PER_FORWARD} x {n_batches} batches)")
        if n != N_CHIPS or launches[dtype] != RDBS_PER_FORWARD * n_batches:
            raise AssertionError(f"main path {dtype}: {n} chips, {launches[dtype]} rdb launches")
        outs[dtype] = []
        for i in range(N_CHIPS):
            sr = read_png(os.path.join(opt["save_path"], str(i), "sr.png"))
            if sr.shape != (128, 128, 3) or sr.dtype != np.uint8:
                raise AssertionError(f"{dtype} sr.png {i}: {sr.shape} {sr.dtype}")
            outs[dtype].append(sr)
    p = psnr(np.stack(outs["float32"]), np.stack(outs["bfloat16"]))
    print(f"bf16 vs f32 sr.png PSNR over {N_CHIPS} chips: {p:.2f} dB (floor 30) "
          f"{'ok' if p >= 30 else 'FAIL'}")
    if not p >= 30:
        raise AssertionError("bf16 output too far from f32")

    # the f32 generator through the kernel against the plain trunk, one batch
    state = load_torch_state_dict(weights)
    pngs = sorted(os.path.join(data_dir, d, "tci.png") for d in os.listdir(data_dir))
    inputs, _ = format_s2naip_batch(pngs[:BATCH], N_LR, seed=0)
    model = RRDBNet(scale=4, device="cpu", **net)
    model.load_state_dict(state)
    model = model.cuda().eval()
    x = torch.from_numpy(inputs).cuda().float() / 255.0
    with torch.no_grad(), tf32_off():
        y_kernel = model(x)
        with plain_trunk():
            y_plain = model(x)
        torch.cuda.synchronize()
    err = (y_kernel - y_plain).abs().max().item()
    finite = bool(torch.isfinite(y_kernel).all())
    print(f"generator f32, kernel vs plain trunk, one batch of {BATCH}: max_abs_err {err:.3e} "
          f"(atol 1e-3), finite {finite} {'ok' if err <= 1e-3 and finite else 'FAIL'}")
    if not (err <= 1e-3 and finite):
        raise AssertionError("generator through the kernel disagrees with the plain trunk")

    # steady-state engine throughput (device-bound part of the main path)
    batches = [inputs] * 8
    profiles = []
    for dtype in (torch.float32, torch.bfloat16):
        m = RRDBNet(scale=4, device="cpu", dtype=dtype, **net)
        engine = InferenceEngine(m, state, batch_size=BATCH, device="cuda")
        engine.run(inputs)  # warm-up: packing, cuDNN plans
        t0 = time.time()
        n = sum(len(y) for y in engine.run_many(batches))
        dt = time.time() - t0
        xd = torch.randn(BATCH, HW, HW, NF, device="cuda", dtype=dtype)
        xc = x.to(dtype)
        with torch.no_grad(), tf32_off():
            fwd_ms = time_ms(lambda: engine.model(xc), iters=5, warmup=1)
            trunk_ms = time_ms(lambda: [b(xd) for b in engine.model.body], iters=5, warmup=1)
        print(f"engine {str(dtype)[6:]}: {n / dt:.2f} img/s, {n / dt / 16:.3f} tiles/s "
              f"(512x512 tile = 16 chips) over {len(batches)} batches of {BATCH}; "
              f"forward {fwd_ms:.3f} ms, trunk {trunk_ms:.3f} ms ({100 * trunk_ms / fwd_ms:.1f}%) "
              f"[{card}]")
        profiles.append((engine.model, xc, fwd_ms))
    # after both engines' timings: a profiler session may slow later launches
    for model_d, x_d, fwd_d in profiles:
        profile_forwards(model_d, x_d, fwd_d)

    # host side of the main path, at the thread counts run_inference uses
    t0 = time.time()
    format_s2naip_batch(pngs, N_LR, seed=0)
    dec = len(pngs) / (time.time() - t0)
    workers = max(2, os.cpu_count() or 1)
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(lambda i: write_png(os.path.join(work, "enc", f"{i}.png"), outs["float32"][i]),
                      range(N_CHIPS)))
    enc = N_CHIPS / (time.time() - t0)
    print(f"host: PNG decode + frame formatting {dec:.2f} img/s ({DECODE_THREADS} threads), "
          f"sr.png encode {enc:.2f} img/s ({workers} threads), {os.cpu_count()} cores")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels (phases 1-2) and stop")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from satlas_sr_tpu_torch.ops.cuda.build import load, ptxas_report

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {kind}", flush=True)
    t0 = time.time()
    load("rdb")
    print(f"built rdb.cu in {time.time() - t0:.1f} s")
    print(f"--- ptxas report for rdb.cu ---\n{ptxas_report('rdb').strip()}")
    kernels = phase_kernels(args.seed)
    if args.kernels_only:
        return 0

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches = phase_main_path(args.seed, work, card)
    shutil.rmtree(work)

    record = []
    for name, dtype, route in (("bf16", "bfloat16", "cuda-wgmma"),
                               ("f32", "float32", "cuda-wgmma-3xtf32")):
        record.append({"name": f"rdb[{name}]", "route": route,
                       "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "launches": launches[dtype], **kernels[name]})
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

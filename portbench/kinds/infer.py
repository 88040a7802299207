"""Closed-loop batch inference through the port's engine, as the infer CLI
runs it: `InferenceEngine.run_many` at a fixed depth over uint8 host
batches.

Traffic parameters: batch_size, depth (batches in flight), pool_batches
(distinct batches drawn from the seed, sent in turn), compute_dtype,
matmul_precision, sample_batches (window batches kept for `correct`, drawn
from the seed), trace_seconds (the profiled stretch after the window).

Set-up: the generator built as the infer CLI builds it (`build_network`,
`InferenceEngine`), the benchmark's weights loaded into it, the pool
drawn, the cell's one shape warmed up. The window: batches in turn until
`seconds` have passed, then the batches in flight drained; every batch
timed from the start of its `dispatch` to the return of its `fetch`. After
the window (and the profiled stretch with --trace 1) the engine is freed and
the kept outputs are compared with the plain reference.
"""

from __future__ import annotations

import contextlib
import random
from typing import Any, Dict, List

import torch

from .. import correct, weights
from ..harness import Cell, Run
from ..reference import nets
from .common import clock, setup_note, device_kind, free, memory_peak, profiled, ranges_on, sync

RDB_RANGE = "portbench::rdb"


def program_opt(cell: Cell) -> Dict[str, Any]:
    """The infer config the program reads: the configuration's sizes and the
    mix's execution settings."""
    tr = cell.traffic
    return {**cell.config, "batch_size": tr["batch_size"], "compute_dtype": tr["compute_dtype"],
            "matmul_precision": tr["matmul_precision"]}


def build(cell: Cell, sd: Dict[str, torch.Tensor], device):
    from satlas_sr_tpu_torch.inference import InferenceEngine
    from satlas_sr_tpu_torch.utils.model_utils import build_network

    opt = program_opt(cell)
    model = build_network(opt, device="cpu")
    return InferenceEngine(model, sd, batch_size=int(opt["batch_size"]),
                           matmul_precision=str(opt["matmul_precision"]), device=device)


def draw_pool(cell: Cell, seed: int, device) -> List:
    tr, cfg = cell.traffic, cell.config
    shape = (tr["pool_batches"], tr["batch_size"], cfg["lr_size"], cfg["lr_size"],
             cfg["network_g"]["num_in_ch"])
    pool = weights.uint8_images(weights.generator(seed, "inputs", device), shape, device)
    return [b.copy() for b in pool.cpu().numpy()]  # one array a batch, as a loader's


def reference_images(cell: Cell, sd, batch_u8, device, **convs) -> torch.Tensor:
    """The reference's uint8 images of one host batch, in float32, TF32 off
    (or through a control's `conv` or `trunk_conv`, nets.rrdbnet's)."""
    x = torch.from_numpy(batch_u8).to(device).float() / 255.0
    with torch.no_grad(), no_tf32():
        y = nets.rrdbnet(sd, x, int(cell.config["network_g"]["num_block"]), **convs)
    return correct.quantize(y)


class no_tf32:
    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev


def window(engine, pool, seconds: float, depth: int, keep: int, rng: random.Random):
    """Run batches in turn for `seconds`; returns (kept [(pool index,
    output)], latencies s, dispatch s, window s). `keep` outputs are kept by
    reservoir sampling, so every batch of the window is equally likely."""
    lat, disp, kept = [], [], []
    dispatch, fetch = engine.dispatch, engine.fetch

    def timed_dispatch(b):
        t = clock()
        h = dispatch(b[1])
        disp.append(clock() - t)
        return h, t, b[0]

    def timed_fetch(handle):
        h, t, i = handle
        out = fetch(h)
        lat.append(clock() - t)
        return i, out

    def batches(stop):
        i = 0
        while clock() < stop:
            yield i % len(pool), pool[i % len(pool)]
            i += 1

    engine.dispatch, engine.fetch = timed_dispatch, timed_fetch
    try:
        t_start = clock()
        for j, got in enumerate(engine.run_many(batches(t_start + seconds), depth)):
            if j < keep:
                kept.append(got)
            else:
                r = rng.randrange(j + 1)
                if r < keep:
                    kept[r] = got
        t_stop = clock()
    finally:
        del engine.dispatch, engine.fetch
    return kept, lat, disp, t_stop - t_start


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device, t0: float) -> Run:
    from satlas_sr_tpu_torch.archs.rrdbnet import ResidualDenseBlock

    tr = cell.traffic
    depth, batch = int(tr["depth"]), int(tr["batch_size"])
    marks = [("imports", clock())]
    sd = weights.rrdbnet_weights(cell.config["network_g"], seed, device)
    marks.append(("weights", clock()))
    engine = build(cell, sd, device)
    marks.append(("engine", clock()))
    pool = draw_pool(cell, seed, device)
    marks.append(("pool", clock()))
    for _ in engine.run_many(pool[:depth + 1], depth):  # the cell's one shape
        pass
    sync(device)
    marks.append(("warm-up", clock()))
    setup_s = clock() - t0

    kept, lat, disp, window_s = window(engine, pool, seconds, depth,
                                       int(tr["sample_batches"]), random.Random(seed))
    n = len(lat)
    ctx: Dict[str, Any] = {
        "kind": "infer", "config": cell.config, "traffic": tr, "device_kind": device_kind(device),
        "setup_s": setup_s, "window_s": window_s, "batches": n, "images": n * batch,
        "batch_latency_s": lat, "dispatch_s": disp}
    tr_ = None
    if trace_on:
        rdbs = [m for m in engine.model.modules() if isinstance(m, ResidualDenseBlock)]
        calls: List = []
        per = max(2 * depth, int(tr["trace_seconds"] * n / window_s))
        run_n = lambda k: [None for _ in engine.run_many((pool[i % len(pool)] for i in range(k)),
                                                         depth)]
        with ranges_on(rdbs, RDB_RANGE, calls):
            tr_ = profiled(lambda: run_n(depth), lambda: run_n(per), device)
        ctx.update(trace=tr_, trace_batches=per, rdb_calls=calls[-len(rdbs) * per:],
                   rdb_range=RDB_RANGE)
    peak = memory_peak(device)
    del engine
    free(device)

    numbers: Dict[str, float] = {}
    for i, out in kept:
        ref = reference_images(cell, sd, pool[i], device)
        numbers = correct.worst(numbers, correct.image_numbers(
            torch.from_numpy(out).to(device), ref))
    return Run(ctx=ctx, attempted=n * batch, failed=0, numbers=numbers, memory_peak_bytes=peak,
               device_kind=device_kind(device), trace=tr_, notes=[setup_note(t0, marks)])


def control(cell: Cell, seed: int, device, trunk_only: bool = False) -> Dict[str, float]:
    """The control's numbers: the reference in the precision below the
    configuration's (reference/lowprec.CONTROLS) in the program's place, on
    `sample_batches` batches of the cell's pool; with `trunk_only`, in the
    dense blocks alone (the heads as the reference computes them)."""
    from ..reference.lowprec import CONTROLS

    sd = weights.rrdbnet_weights(cell.config["network_g"], seed, device)
    pool = draw_pool(cell, seed, device)
    low_conv = {("trunk_conv" if trunk_only else "conv"): CONTROLS[cell.traffic["compute_dtype"]]}
    numbers: Dict[str, float] = {}
    for i in range(int(cell.traffic["sample_batches"])):
        batch = pool[i % len(pool)]
        ref = reference_images(cell, sd, batch, device)
        low = reference_images(cell, sd, batch, device, **low_conv)
        numbers = correct.worst(numbers, correct.image_numbers(low, ref))
    return numbers


@contextlib.contextmanager
def swapped_answers(cell: Cell):
    """Fault: answers altered where they are produced: the engine's first
    two images of every batch come back swapped, each the other's answer."""
    from satlas_sr_tpu_torch import inference

    program = inference.uint8_program

    def broken(model, dtype, x):
        return program(model, dtype, x)[[1, 0] + list(range(2, x.shape[0]))]

    inference.uint8_program = broken
    try:
        yield
    finally:
        inference.uint8_program = program


@contextlib.contextmanager
def dropped_block(cell: Cell):
    """Fault in the trunk: one dense block of every forward, the middle one,
    returns its input, its 0.2-scaled branch left out where the op is
    called."""
    from satlas_sr_tpu_torch.archs import rrdbnet

    op, blocks = rrdbnet.rdb, 3 * int(cell.config["network_g"]["num_block"])
    calls = [0]

    def broken(x, *args, **kw):
        calls[0] += 1
        return x if calls[0] % blocks == blocks // 2 + 1 else op(x, *args, **kw)

    rrdbnet.rdb = broken
    try:
        yield
    finally:
        rrdbnet.rdb = op


FAULTS = {"swapped_answers": swapped_answers, "dropped_block": dropped_block}

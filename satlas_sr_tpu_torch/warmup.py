"""Warm-up CLI: build a config's CUDA kernels and run each of its programs
once on synthetic data, with no dataset and no weights.

    python -m satlas_sr_tpu_torch.warmup -opt options/esrgan_s2naip_urban.yml
    python -m satlas_sr_tpu_torch.warmup -opt options/infer_example.yml [--device cpu]

Counterpart of satlas_sr_tpu/warmup.py, which fills XLA's persistent
compile cache. The port compiles no program per process; what a fresh
process pays on its first step instead is: the CUDA sources it needs built
by nvcc into build/torch_kernels (ops/cuda/build.py, kept across processes
by the source's hash), CUDA's lazy module loading, cuDNN's algorithm choice
and the first launch of each kernel. Warming runs exactly those: the kernel
build, then the config's programs once each on data of the config's shapes,
with the seconds of each printed: the train step and each validation
dataset's eval forward for a train config (`model_type` present), the
InferenceEngine's batch (chunked, `whole_tile` or halo windows) for an
infer config; whole-tile's split over its `spatial_shards` ranks (or the
default split) runs this rank's band, so a sharded launch warms on every
rank of its group. The JAX package's utils/jax_cache.py has no module here: its
platform pin is device.resolve_device, its persistent cache the kernel
build's.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .device import resolve_device


def _synth_batch(ds_opt: dict, scale: int, rows: int, with_old: bool) -> dict:
    """Random batch shaped exactly like S2NAIPDataset output for this config."""
    t = int(ds_opt.get("n_s2_images", 8))
    bands = ds_opt.get("s2_bands") or ["tci"]
    # per-frame channels: tci is RGB, every other band is single-channel
    # (data/s2naip.py _load_bands; same derivation as ESRGANModel num_in_ch)
    c = 3 + (len(bands) - 1)
    rng = np.random.RandomState(0)
    if ds_opt.get("use_3d"):
        lr = (rng.rand(rows, t, 32, 32, c) * 255).astype(np.uint8)
    else:
        lr = (rng.rand(rows, 32, 32, t * c) * 255).astype(np.uint8)
    batch = {
        "lr": lr,
        "hr": (rng.rand(rows, 32 * scale, 32 * scale, 3) * 255).astype(np.uint8),
        "Chip": [f"warmup_{i}" for i in range(rows)],
    }
    if with_old:
        batch["old_hr"] = (
            rng.rand(rows, 32 * scale, 32 * scale, 3) * 255
        ).astype(np.uint8)
    return batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(network_type: str, device: torch.device) -> None:
    """Build (or find built) the CUDA sources a network's forward launches."""
    if device.type != "cuda" or network_type != "SSR_RRDBNet":
        return
    from .ops.cuda.build import library_path, load

    t0 = time.time()
    built = library_path("rdb").exists()
    load("rdb")
    print(f"[warmup] rdb.cu {'found built' if built else 'built'} in {time.time() - t0:.1f}s "
          f"({library_path('rdb')})")


def warmup_train(opt: dict, device="cuda") -> None:
    from .models import build_model

    device = resolve_device(device)
    build_kernels(opt["network_g"]["type"], device)
    scale = int(opt.get("scale", 4))
    t0 = time.time()
    model = build_model(opt, device=device)
    ds = opt["datasets"]["train"]
    # one card; the loader's batch: accum_steps micro-batches of batch_size_per_gpu
    accum = int((opt.get("train") or {}).get("accum_steps", 1) or 1)
    rows = int(ds.get("batch_size_per_gpu", 16)) * accum
    batch = _synth_batch(ds, scale, rows, with_old=bool(ds.get("old_naip_path")))
    model.train_iter(batch, 1)
    _sync(device)
    split = f" in {accum} micro-batches" if accum > 1 else ""
    print(f"[warmup] train step ({rows} rows){split}: built+ran in {time.time() - t0:.1f}s")

    for phase, vds in opt["datasets"].items():
        if phase == "train" or vds is None:
            continue
        t0 = time.time()
        vrows = int(vds.get("batch_size", 1))
        model.eval_outputs(_synth_batch(vds, scale, vrows, with_old=False))
        _sync(device)
        print(f"[warmup] eval step '{phase}' ({vrows} rows): ran in {time.time() - t0:.1f}s")


def warmup_infer(opt: dict, device="cuda") -> None:
    from .infer import load_infer_variables
    from .infer_grid import _window_starts, whole_tile_shards
    from .inference import InferenceEngine
    from .utils.infer_utils import channels_per_frame
    from .utils.model_utils import build_network, config_scale, uses_3d_input

    device = resolve_device(device)
    build_kernels(opt["network_g"]["type"], device)
    n_lr_images = int(opt["n_lr_images"])
    use_3d = uses_3d_input(opt["network_g"]["type"])
    whole = bool(opt.get("whole_tile"))
    grid_size = int(opt.get("grid_size", 16))
    if opt.get("halo") and not whole:
        # halo mode runs sliding windows of halo_window (default 32) at
        # batch min(256, windows/tile): warm THAT shape
        halo = opt.get("halo", 6)
        halo = 6 if halo is True else int(halo)
        length = grid_size * 32
        size = min(int(opt.get("halo_window", 32)), length)
        n_win = len(_window_starts(length, size, size - 2 * halo)) ** 2
        batch_size = int(opt.get("batch_size", min(256, n_win)))
    else:
        size = grid_size * 32 if whole else 32
        batch_size = int(opt.get("batch_size", 1 if whole else 64))
    # spatial_shards splits only the whole-tile program's rows (run_whole_tile);
    # the chunked and halo engines run without it
    spatial = whole_tile_shards(opt) if whole else 1
    if whole:
        if use_3d:
            opt = {**opt, "network_g": {**opt["network_g"],
                                        "output_size": size * config_scale(opt)}}

    t0 = time.time()
    model = build_network(opt, device="cpu")
    engine = InferenceEngine(model, load_infer_variables(opt, model), batch_size=batch_size,
                             use_3d=use_3d, n_frames=n_lr_images,
                             matmul_precision=str(opt.get("matmul_precision", "highest")),
                             device=device, spatial_shards=spatial)
    c = 3 if use_3d else channels_per_frame(opt.get("s2_bands"))
    engine.run(np.zeros((engine.batch_size, size, size, n_lr_images * c), np.uint8))
    mode = "whole-tile" if whole else "halo" if opt.get("halo") else "chunked"
    band = engine.band_rows(size)
    rows = f", rows {band[0]}:{band[1]} of {spatial} bands" if band else ""
    print(f"[warmup] {mode} inference (batch {engine.batch_size}, {size}x{size}{rows}): "
          f"built+ran in {time.time() - t0:.1f}s")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to the options file.")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm", "jax"], default="none",
                        help="run as one rank of torch.distributed (a whole-tile config's "
                        "spatial_shards > 1 warms its row bands on every rank of the group)")
    args, extra = parser.parse_known_args(argv)
    device = args.device

    from .utils.options import close_distributed, init_distributed, yaml_load

    raw = yaml_load(args.opt)
    if raw.get("model_type"):
        # full option parsing without touching disk: warmup never creates
        # experiment dirs. Extra args (--force_yml/--debug/...) forward so
        # shape-changing overrides warm the SAME program the real launch runs.
        from .utils.options import parse_options

        opt, _ = parse_options(os.getcwd(), is_train=True,
                               argv=["-opt", args.opt, "--launcher", args.launcher, *extra])
        try:
            warmup_train(opt, device)
        finally:
            close_distributed()
    else:
        if extra:
            raise SystemExit(f"warmup: unrecognised arguments for an infer config: {extra}")
        try:
            init_distributed(args.launcher, device)
            warmup_infer(raw, device)
        finally:
            close_distributed()
    print("[warmup] kernels built and every program run once.")


if __name__ == "__main__":
    main()

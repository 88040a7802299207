"""GT-free inference CLI.

`python -m satlas_sr_tpu_torch.infer -opt <yml>` reads the same infer configs
as `satlas_sr_tpu.infer` (data_dir / n_lr_images / save_path / network_g /
path), globs `**/*.png`, super-resolves each and writes
`{save_path}/{i}/sr.png` plus the first low-res frame as `lr.png`.

- `s2_bands`: data_dir holds chip directories of {band}.png files, each chip
  identified by its tci.png; the bands are stacked per frame
  (utils/infer_utils.py) into an SSR_RRDBNet's wider first conv.
- SRCNN / HighResNet take the frames as a 5-D revisit stack (`use_3d`).
- `grid_naming` (infer_grid's chunked mode) writes `{tile}/{i}_{j}.png`.
- `skip_existing` resumes an interrupted corpus, guarded by the corpus
  manifest.
- `--launcher pytorch|jax|slurm`: each rank (one card each, or gloo
  processes with `--device cpu`) takes a contiguous block of the sorted
  corpus (`shard_contiguous`; whole tiles in grid mode). Outputs and frame
  RNG salts are keyed by global corpus index, so the union of the ranks'
  outputs is byte-equal to a one-process run. The manifest guard runs over
  the whole corpus before the split, and rank 0 writes the manifest.
Batches are decoded on a prefetching thread pool (one native call per
batch), run through the batched InferenceEngine, and written by a bounded
writer pool.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

from .device import resolve_device
from .inference import BoundedWriter, InferenceEngine, batched, prefetch_map
from .utils.checkpoint import load_network_variables
from .utils.imgio import write_png
from .utils.infer_utils import (format_s2naip_batch, format_s2naip_multiband_batch,
                                normalize_bands)
from .utils.model_utils import build_network, uses_3d_input
from .utils.options import close_distributed, init_distributed, yaml_load


def load_infer_variables(opt: dict, model):
    """Configured weights as a state dict, or the model's own seeded init
    (with the reference's warning)."""
    path_opt = opt.get("path", {})
    weights = path_opt.get("pretrain_network_g")
    if weights:
        return load_network_variables(opt["network_g"]["type"], weights, opt["network_g"],
                                      path_opt.get("param_key_g", "params_ema"))
    print("WARNING: Model weights are not specified in configuration file.")
    return model.state_dict()


def _paths_digest(rel_paths) -> str:
    return hashlib.sha256("\n".join(rel_paths).encode()).hexdigest()


def corpus_fingerprint(pngs, data_dir: str) -> dict:
    """Sorted relative-path corpus count + sha256 over the enumeration."""
    rel = [os.path.relpath(p, data_dir) for p in pngs]
    return {"count": len(rel), "sha256": _paths_digest(rel), "_rel": rel}


def guard_corpus_manifest(save_path: str, pngs, data_dir: str, rank: int = 0,
                          force: bool = False) -> None:
    """Refuse a skip_existing resume over a mutated corpus.

    Outputs and frame-RNG salts are keyed by position in the sorted corpus,
    so adding or removing an input between interrupt and resume would shift
    every later index. The first skip_existing run writes
    `{save_path}/.ssr_corpus_manifest.json` (count + sha256 of the sorted
    relative paths); later runs verify it, accept a pure tail append (and
    extend the manifest), and refuse anything else. `force` accepts the
    current corpus as the new enumeration. Every rank checks; rank 0 writes.
    """
    man_path = os.path.join(save_path, ".ssr_corpus_manifest.json")
    fp = corpus_fingerprint(pngs, data_dir)
    rel = fp.pop("_rel")

    def _write():
        if rank != 0:
            return
        os.makedirs(save_path, exist_ok=True)
        tmp = f"{man_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(fp, f)
        os.replace(tmp, man_path)

    if os.path.exists(man_path) and not force:
        with open(man_path) as f:
            prev = json.load(f)
        prev_n = prev.get("count")
        if (prev_n, prev.get("sha256")) == (fp["count"], fp["sha256"]):
            return
        # pure tail append: the current corpus's first prev_n paths hash to
        # the old digest iff the old enumeration is a prefix of this one
        if (isinstance(prev_n, int) and prev_n <= fp["count"]
                and _paths_digest(rel[:prev_n]) == prev.get("sha256")):
            print(f"skip_existing: corpus grew {prev_n} -> {fp['count']} files "
                  "(append-only at the tail of the sort order — existing indices "
                  "unchanged); manifest extended.")
            _write()
            return
        raise RuntimeError(
            "skip_existing: the input corpus changed since this save_path was first "
            f"written ({prev_n} files then, {fp['count']} now) and not by a pure tail "
            "append. Outputs and frame-RNG salts are keyed by position in the sorted "
            "corpus, so resuming would silently mix two inconsistent enumerations. "
            "Either point save_path somewhere fresh, or re-run with --force to "
            "re-enumerate (existing index-keyed outputs may then correspond to "
            "different inputs).")
    _write()


def shard_contiguous(n_items: int, rank: int, world: int) -> range:
    """Balanced contiguous [start, stop) range of n_items for process `rank`."""
    base, extra = divmod(n_items, world)
    start = rank * base + min(rank, extra)
    return range(start, start + base + (1 if rank < extra else 0))


def _grid_name(path: str):
    """{tile}/{i}_{j}.png of a grid chunk's path."""
    return os.path.basename(os.path.dirname(path)), os.path.basename(path)


def run_inference(opt: dict, save_lr: bool = True, grid_naming: bool = False,
                  rank: int = 0, world: int = 1, force: bool = False, device="cuda") -> int:
    """Super-resolve every PNG (or, with s2_bands, every chip dir) under
    opt['data_dir'] (rank `rank`'s block of them); returns the count written."""
    device = resolve_device(device)
    data_dir = opt["data_dir"]
    n_lr_images = int(opt["n_lr_images"])
    save_path = opt["save_path"]
    batch_size = int(opt.get("batch_size", 64))
    use_3d = uses_3d_input(opt["network_g"]["type"])
    s2_bands = opt.get("s2_bands")
    if s2_bands:
        if grid_naming:
            raise ValueError("s2_bands is not supported for infer_grid "
                             "(grid tiles ship chunk-level tci pngs only)")
        if use_3d:
            raise ValueError("s2_bands requires SSR_RRDBNet (the use_3d models take "
                             "3-channel revisits)")
        s2_bands = normalize_bands(s2_bands)

    model = build_network(opt, device="cpu")
    variables = load_infer_variables(opt, model)
    engine = InferenceEngine(model, variables, batch_size=batch_size, use_3d=use_3d,
                             n_frames=n_lr_images,
                             matmul_precision=str(opt.get("matmul_precision", "highest")),
                             device=device)

    if s2_bands:  # corpus unit: one chip directory, identified by its tci.png
        pngs = sorted(os.path.dirname(p) for p in
                      glob.glob(os.path.join(data_dir, "**", "tci.png"), recursive=True))
    else:
        pngs = sorted(glob.glob(os.path.join(data_dir, "**", "*.png"), recursive=True))
    total = len(pngs)
    if opt.get("skip_existing"):
        # over the whole corpus, before the split: every rank agrees on the
        # global enumeration before any index-keyed work
        guard_corpus_manifest(save_path, pngs, data_dir, rank=rank, force=force)
    if world > 1:
        # contiguous blocks keep the global-index frame salts a scalar offset;
        # grid mode splits whole tiles, so each tile's chunks (and its stitch)
        # stay on one rank
        if grid_naming:
            tiles = sorted({os.path.dirname(p) for p in pngs})
            mine = {tiles[i] for i in shard_contiguous(len(tiles), rank, world)}
            idx = [i for i, p in enumerate(pngs) if os.path.dirname(p) in mine]
        else:
            idx = list(shard_contiguous(total, rank, world))
        pngs = [pngs[i] for i in idx]
        print(f"Process {rank}/{world}: inference on {len(pngs)} of {total} images.")
    else:
        idx = list(range(total))
        print(f"Running inference on {len(pngs)} images.")
    if opt.get("skip_existing"):

        # outputs are keyed by GLOBAL corpus index and the frame RNG is salted
        # by that index, so recomputing only the missing outputs is
        # bit-identical to a full run
        def _is_done(gi: int, path: str) -> bool:
            if grid_naming:
                return os.path.exists(os.path.join(save_path, *_grid_name(path)))
            out_dir = os.path.join(save_path, str(gi))
            names = ("lr.png", "sr.png") if save_lr else ("sr.png",)
            return all(os.path.exists(os.path.join(out_dir, f)) for f in names)

        kept = [(gi, p) for gi, p in zip(idx, pngs) if not _is_done(gi, p)]
        if len(kept) < len(pngs):
            print(f"skip_existing: {len(pngs) - len(kept)} outputs already present, "
                  f"{len(kept)} to compute.")
        idx = [gi for gi, _ in kept]
        pngs = [p for _, p in kept]

    t0 = time.time()
    seed = opt.get("manual_seed", 0) or 0
    meta: list = []  # (paths, previews, global indices) per batch, in flight order
    workers = max(2, os.cpu_count() or 1)
    decode_prefetch = int(opt.get("decode_prefetch", 3))
    decode_pool = ThreadPoolExecutor(max_workers=decode_prefetch)
    write_pool = ThreadPoolExecutor(max_workers=workers)
    writer = BoundedWriter(write_pool, max_pending=4 * workers)

    def decode(arg):
        bp, bidx = arg
        if s2_bands:
            return bp, bidx, format_s2naip_multiband_batch(bp, s2_bands, n_lr_images,
                                                           seed=seed, indices=bidx)
        return bp, bidx, format_s2naip_batch(bp, n_lr_images, seed=seed, indices=bidx)

    def produce():
        for bp, bidx, (inputs, previews) in prefetch_map(
                decode_pool, decode, zip(batched(pngs, engine.batch_size),
                                         batched(idx, engine.batch_size)),
                decode_prefetch):
            meta.append((bp, previews, bidx))
            yield inputs

    done = 0
    try:
        for outputs in engine.run_many(produce()):
            paths, previews, bidx = meta.pop(0)
            for k, gi in enumerate(bidx):
                if grid_naming:  # {tile}/{i}_{j}.png, for stitching
                    writer.submit(write_png, os.path.join(save_path, *_grid_name(paths[k])),
                                  outputs[k])
                else:
                    out_dir = os.path.join(save_path, str(gi))
                    if save_lr:
                        writer.submit(write_png, os.path.join(out_dir, "lr.png"), previews[k])
                    writer.submit(write_png, os.path.join(out_dir, "sr.png"), outputs[k])
                done += 1
        writer.drain()  # surface any write error
    finally:
        decode_pool.shutdown(wait=True)
        write_pool.shutdown(wait=True)
    dt = time.time() - t0
    if done:
        print(f"Done: {done} images in {dt:.2f}s ({done / dt:.1f} img/s)")
    return done


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to the options file.")
    parser.add_argument("--force", action="store_true",
                        help="with skip_existing: accept a corpus that changed since "
                        "save_path's manifest was written (re-enumerate).")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm", "jax"], default="none",
                        help="shard the corpus over torch.distributed ranks (torchrun's env://)")
    args = parser.parse_args(argv)
    try:
        rank, world = init_distributed(args.launcher, args.device)
        run_inference(yaml_load(args.opt), rank=rank, world=world, force=args.force,
                      device=args.device)
    finally:
        close_distributed()


if __name__ == "__main__":
    main()

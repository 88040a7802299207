"""Tile-grid inference and stitching CLI.

`python -m satlas_sr_tpu_torch.infer_grid -opt <yml> [--device cpu]` reads the
same configs as `satlas_sr_tpu.infer_grid`. data_dir holds tiles, each a
directory of `{i}_{j}.png` chunks (16x16 by default, each [T*32, 32, 3]).
Three modes:

- chunked (the default): every chunk is super-resolved on its own
  (run_inference with grid_naming), then every tile with all 256 chunks is
  stitched into stitched_sr.png (2048x2048) and stitched_s2.png (512x512,
  each chunk's first frame). Interior chunk edges see zero padding.
- `whole_tile: true`: one generator pass over each assembled 512x512 tile
  (`batch_size` tiles a pass), a seamless 2048x2048 output. For the 5-D
  models (SRCNN, HighResNet) `output_size` scales by `grid_size`. The
  tile's rows split over `spatial_shards` ranks (0: `default_spatial_shards`),
  a space group of parallel/mesh.mesh_2d: each rank decodes and
  super-resolves its own band of rows (halo exchanges with the neighbour
  bands, parallel/halo.py), the bands are gathered and space index 0
  writes the stitched files. The tiles split over the data groups.
- `halo: N` (default 6; `halo_window` default 32): overlapping windows of the
  chunk's size at stride window - 2N, edge-aligned at the tile border so the
  conv's own zero padding applies there as in a whole-tile pass; each output
  pixel comes from the window where it has >= N pixels of context on every
  non-border side. 4-D (frame-stacked) models only.

Every mode keeps `skip_existing` (a tile is done when both stitched files
exist) behind the corpus manifest guard, and seeds each chunk's frame RNG
by its index in the sorted recursive glob, as the chunked mode does.
`--launcher` splits the tiles into contiguous blocks over the ranks (each
rank super-resolves and stitches its own tiles; in whole-tile mode over the
data groups, each group's space index 0 writing them).
"""

from __future__ import annotations

import argparse
import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .device import resolve_device
from .infer import guard_corpus_manifest, load_infer_variables, run_inference, shard_contiguous
from .inference import BoundedWriter, InferenceEngine, batched, prefetch_map
from .parallel import mesh
from .parallel.halo import gather_rows
from .utils.imgio import write_png
from .utils.infer_utils import assemble_tile, stitch
from .utils.model_utils import build_network, config_scale, uses_3d_input
from .utils.options import close_distributed, init_distributed, local_world_size, yaml_load


def _skip_done_tiles(tiles, save_path: str, mode: str):
    """skip_existing filter of the seam-free modes: a tile is done when both
    stitched outputs exist."""
    kept = [t for t in tiles
            if not (os.path.exists(os.path.join(save_path, t, "stitched_sr.png"))
                    and os.path.exists(os.path.join(save_path, t, "stitched_s2.png")))]
    if len(kept) != len(tiles):
        print(f"skip_existing: {len(tiles) - len(kept)} {mode} tiles already "
              f"stitched, {len(kept)} to compute.")
    return kept


def stitch_tiles(data_dir: str, save_path: str, rank: int = 0, world: int = 1,
                 skip_existing: bool = False) -> None:
    """Stitch every tile with 256 chunks (tiles as run_inference's glob finds
    them, so rank `rank` stitches the block of tiles it super-resolved)."""
    pngs = glob.glob(os.path.join(data_dir, "**", "*.png"), recursive=True)
    tile_dirs = sorted({os.path.dirname(p) for p in pngs})
    tile_dirs = [tile_dirs[i] for i in shard_contiguous(len(tile_dirs), rank, world)]
    for tile_dir in tile_dirs:
        tile = os.path.basename(tile_dir)
        out_sr = os.path.join(save_path, tile, "stitched_sr.png")
        out_s2 = os.path.join(save_path, tile, "stitched_s2.png")
        if skip_existing and os.path.exists(out_sr) and os.path.exists(out_s2):
            continue
        print("Stitching images for tile", tile)
        if len(os.listdir(tile_dir)) < 256:
            print(f"Tile {tile} contains less than 256 chunks, cannot stitch. Skipping.")
            continue
        stitch(os.path.join(save_path, tile), 2048, out_sr)
        stitch(tile_dir, 512, out_s2, sentinel2=True)


def default_spatial_shards(rows: int) -> int:
    """Largest power of 2 dividing both the ranks on this host (1 without a
    launcher; one rank is one card) and `rows`: the whole-tile split when
    `spatial_shards` is 0 or unset. Shared with the warmup CLI."""
    n = local_world_size(mesh.world_size())
    spatial = 1
    while n % (spatial * 2) == 0 and rows % (spatial * 2) == 0:
        spatial *= 2
    return spatial


def whole_tile_shards(opt: dict) -> int:
    """The configured `spatial_shards`, or the default split when it is 0."""
    spatial = int(opt.get("spatial_shards", 0) or 0)
    return spatial if spatial > 0 else default_spatial_shards(int(opt.get("grid_size", 16)) * 32)


def _gather_host(arr: np.ndarray, space) -> np.ndarray:
    """Every rank's band of host rows [B, h, ...] of the group, in space
    order (a backend's collective device and back)."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.collective_device())
    return gather_rows(t, space).cpu().numpy()


def _discover_tiles(data_dir: str, grid_size: int, rank: int, world: int, mode: str,
                    detail: str):
    """Tile dirs with a full chunk grid, in sorted order: rank `rank`'s
    contiguous block of them."""
    tiles = []
    for tile in sorted(os.listdir(data_dir)):
        tile_dir = os.path.join(data_dir, tile)
        if not os.path.isdir(tile_dir):
            continue
        if len(os.listdir(tile_dir)) < grid_size * grid_size:
            print(f"Tile {tile} contains less than {grid_size * grid_size} "
                  "chunks, cannot super-resolve whole. Skipping.")
            continue
        tiles.append(tile)
    if world > 1:
        n_total = len(tiles)
        tiles = [tiles[i] for i in shard_contiguous(n_total, rank, world)]
        print(f"Process {rank}/{world}: {mode} inference on {len(tiles)} of {n_total} tiles "
              f"({detail}).")
    else:
        print(f"{mode} inference on {len(tiles)} tiles ({detail}).")
    return tiles


def _build_index_map(data_dir: str):
    """path -> global corpus index over the sorted recursive png glob: the
    chunked mode's frame-RNG salt, which the seam-free modes reproduce."""
    all_pngs = sorted(glob.glob(os.path.join(data_dir, "**", "*.png"), recursive=True))
    return {p: i for i, p in enumerate(all_pngs)}


def _tiles_to_run(opt: dict, tiles, index_map, mode: str, rank: int, force: bool):
    if not opt.get("skip_existing"):
        return tiles
    # the frame RNG is salted by global corpus index: a corpus mutated between
    # interrupt and resume would shift later salts, so guard first
    guard_corpus_manifest(opt["save_path"], list(index_map), opt["data_dir"], rank=rank,
                          force=force)
    return _skip_done_tiles(tiles, opt["save_path"], mode)


def run_whole_tile(opt: dict, rank: int = 0, world: int = 1, force: bool = False,
                   device="cuda") -> int:
    """One generator pass per whole tile, its rows split over a space group
    (see the module docstring); returns the tiles this rank's group ran."""
    device = resolve_device(device)
    data_dir, save_path = opt["data_dir"], opt["save_path"]
    n_lr_images = int(opt["n_lr_images"])
    seed = int(opt.get("manual_seed", 0) or 0)
    grid_size = int(opt.get("grid_size", 16))
    spatial = whole_tile_shards(opt)
    use_3d = uses_3d_input(opt["network_g"]["type"])
    if use_3d:
        # output_size targets ONE 32x32 chunk; the whole tile scales it
        opt = {**opt, "network_g": {**opt["network_g"],
                                    "output_size": grid_size * 32 * config_scale(opt)}}
    model = build_network(opt, device="cpu")
    variables = load_infer_variables(opt, model)
    engine = InferenceEngine(model, variables, batch_size=int(opt.get("batch_size", 1)),
                             use_3d=use_3d, n_frames=n_lr_images,
                             matmul_precision=str(opt.get("matmul_precision", "highest")),
                             device=device, spatial_shards=spatial)
    space = engine.space or mesh.SpaceLayout(0, 1, rank, world, None, (rank,))
    band = engine.band_rows(grid_size * 32)
    tiles = _discover_tiles(data_dir, grid_size, space.data_index, space.data_size,
                            "Whole-tile", f"spatial_shards={spatial}, batch={engine.batch_size}")
    index_map = _build_index_map(data_dir)
    tiles = _tiles_to_run(opt, tiles, index_map, "whole-tile", rank, force)

    pool = ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 1))
    writer = BoundedWriter(pool, max_pending=8)
    groups = batched(tiles, engine.batch_size)
    previews: list = []

    def assemble_group(group):
        return [assemble_tile(os.path.join(data_dir, t), n_lr_images, seed, grid_size,
                              index_map=index_map, rows=band) for t in group]

    def produce():
        for pairs in prefetch_map(pool, assemble_group, groups, depth=3):
            previews.append([p for _, p in pairs])
            yield np.stack([c for c, _ in pairs])

    def results():
        if band is None:  # whole rows on every rank of the group
            yield from engine.run_many(produce())
            return
        for gi, x in enumerate(produce()):
            previews[gi] = _gather_host(np.stack(previews[gi]), space)
            yield _gather_host(engine.run_band(x), space)

    count = 0
    try:
        for gi, outputs in enumerate(results()):
            for k, tile in enumerate(groups[gi]):
                if space.space_index == 0:
                    out_dir = os.path.join(save_path, tile)
                    writer.submit(write_png, os.path.join(out_dir, "stitched_sr.png"), outputs[k])
                    writer.submit(write_png, os.path.join(out_dir, "stitched_s2.png"),
                                  previews[gi][k])
                count += 1
            previews[gi] = None  # the writer's task holds its own reference
        writer.drain()
    finally:
        pool.shutdown(wait=True)
    print(f"Done: {count} whole tiles.")
    return count


def _window_starts(length: int, win: int, stride: int):
    """Sliding-window starts covering [0, length), the last one edge-aligned."""
    if win >= length:
        return [0]
    starts = list(range(0, length - win + 1, stride))
    if starts[-1] != length - win:
        starts.append(length - win)
    return starts


def _responsibility(starts, win: int, length: int):
    """[(lo, hi)] rows each window owns: overlap midpoints inside, the tile
    border at the ends. At stride win - 2*halo each owned pixel has >= halo
    pixels of context on every non-border side."""
    bounds = [0] + [(a + win + b) // 2 for a, b in zip(starts, starts[1:])] + [length]
    return list(zip(bounds[:-1], bounds[1:]))


def run_halo_tiles(opt: dict, rank: int = 0, world: int = 1, force: bool = False,
                   device="cuda") -> int:
    """Seam-free chunked inference through overlapping windows; returns the
    tile count. 4-D (frame-stacked conv) models only."""
    device = resolve_device(device)
    data_dir, save_path = opt["data_dir"], opt["save_path"]
    n_lr_images = int(opt["n_lr_images"])
    seed = int(opt.get("manual_seed", 0) or 0)
    grid_size = int(opt.get("grid_size", 16))
    scale = config_scale(opt)
    halo = opt.get("halo", 6)
    # `halo: true` means the default width (int(True) would be a halo of 1)
    halo = 6 if halo is True else int(halo)
    length = grid_size * 32
    win = min(int(opt.get("halo_window", 32)), length)
    if win <= 2 * halo:
        raise ValueError(f"halo_window={win} must exceed 2*halo={2 * halo}")
    if uses_3d_input(opt["network_g"]["type"]):
        raise ValueError("halo mode supports the 4-D conv families (e.g. SSR_RRDBNet); "
                         "use whole_tile: true for the 5-D (use_3d) models")
    model = build_network(opt, device="cpu")
    variables = load_infer_variables(opt, model)
    starts = _window_starts(length, win, win - 2 * halo)
    owns = _responsibility(starts, win, length)
    n_side = len(starts)
    n_win = n_side ** 2
    engine = InferenceEngine(model, variables, batch_size=int(opt.get("batch_size", min(256, n_win))),
                             n_frames=n_lr_images,
                             matmul_precision=str(opt.get("matmul_precision", "highest")),
                             device=device)
    tiles = _discover_tiles(data_dir, grid_size, rank, world, "Halo",
                            f"halo={halo}, window={win}, {n_win} windows/tile, "
                            f"batch={engine.batch_size}")
    index_map = _build_index_map(data_dir)
    tiles = _tiles_to_run(opt, tiles, index_map, "halo", rank, force)

    pool = ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 1))
    writer = BoundedWriter(pool, max_pending=8)
    previews: list = []
    coords = [(si, sj) for si in starts for sj in starts]

    def assemble(tile):
        canvas, preview = assemble_tile(os.path.join(data_dir, tile), n_lr_images, seed,
                                        grid_size, index_map=index_map)
        return np.stack([canvas[si:si + win, sj:sj + win] for si, sj in coords]), preview

    def produce():
        for windows, preview in prefetch_map(pool, assemble, tiles, depth=3):
            previews.append(preview)
            for k in range(0, n_win, engine.batch_size):
                yield windows[k:k + engine.batch_size]

    count, placed, s = 0, 0, scale
    sr_canvas = None
    try:
        for outputs in engine.run_many(produce()):
            for out in outputs:
                if sr_canvas is None:
                    sr_canvas = np.empty((length * s, length * s, 3), np.uint8)
                wi, wj = divmod(placed, n_side)
                si, sj = starts[wi], starts[wj]
                (ri0, ri1), (rj0, rj1) = owns[wi], owns[wj]
                sr_canvas[ri0 * s:ri1 * s, rj0 * s:rj1 * s] = \
                    out[(ri0 - si) * s:(ri1 - si) * s, (rj0 - sj) * s:(rj1 - sj) * s]
                placed += 1
                if placed == n_win:
                    out_dir = os.path.join(save_path, tiles[count])
                    writer.submit(write_png, os.path.join(out_dir, "stitched_sr.png"), sr_canvas)
                    writer.submit(write_png, os.path.join(out_dir, "stitched_s2.png"),
                                  previews[count])
                    previews[count] = None  # the writer's task holds its own reference
                    count += 1
                    sr_canvas, placed = None, 0
        writer.drain()
    finally:
        pool.shutdown(wait=True)
    print(f"Done: {count} tiles (halo mode).")
    return count


def run_grid(opt: dict, rank: int = 0, world: int = 1, force: bool = False,
             device="cuda") -> int:
    """The config's mode: whole_tile, halo, or chunked inference + stitch, on
    rank `rank`'s tiles. Returns the tiles (seam-free modes) or chunks
    (chunked) super-resolved."""
    if opt.get("whole_tile"):
        return run_whole_tile(opt, rank, world, force=force, device=device)
    if opt.get("halo"):
        return run_halo_tiles(opt, rank, world, force=force, device=device)
    n = run_inference(opt, save_lr=False, grid_naming=True, rank=rank, world=world, force=force,
                      device=device)
    stitch_tiles(opt["data_dir"], opt["save_path"], rank, world,
                 skip_existing=bool(opt.get("skip_existing")))
    return n


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to the options file.")
    parser.add_argument("--force", action="store_true",
                        help="with skip_existing: accept a corpus that changed since "
                        "save_path's manifest was written (re-enumerate).")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm", "jax"], default="none",
                        help="split the tiles over torch.distributed ranks (torchrun's env://)")
    args = parser.parse_args(argv)
    try:
        rank, world = init_distributed(args.launcher, args.device)
        run_grid(yaml_load(args.opt), rank, world, force=args.force, device=args.device)
    finally:
        close_distributed()


if __name__ == "__main__":
    main()

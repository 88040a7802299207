"""Raw imagery -> S2-NAIP on-disk tree (the JAX package's `prepare.py`,
host only): the reference README's "How to Process Raw Sentinel-2 Data"
section (README.md:115-129) as a working tool.

    python -m satlas_sr_tpu_torch.prepare chip --input s2.png --origin X,Y \
        --out data/ [--role s2|naip] [--band tci] [--uuid u]
    python -m satlas_sr_tpu_torch.prepare reproject src.tif dst.tif --role s2

The port writes its chips through its own PNG codec (utils/imgio.py, on
zlib): the pixels equal the JAX tool's, the compressed bytes are the
codec's own. It runs no model and touches no device.

The reference documents the workflow only as pseudo-code (which, as printed,
does not run: `img`/`meta` are used before any read and a paren is
unbalanced) and leaves the chipping step — raster to `sentinel2/{tile}/
{band}.png` time-series chips on the 2^17 x 2^17 Web-Mercator grid
(README.md:86-113) — entirely to the reader. This CLI does both halves:

  reproject  source raster -> EPSG:3857 at the S2-NAIP ground resolution
             (9.5546 m/px for Sentinel-2 chips; 2.3887 m/px for NAIP),
             bilinear, via rasterio. rasterio is not a framework dependency:
             without it the subcommand refuses loudly and prints the exact
             recipe to run elsewhere.

  chip       a reprojected raster (+ its top-left EPSG:3857 origin) ->
             S2-NAIP tree chips, pure numpy/PNG:
               role s2   -> sentinel2/{col}_{row}/{band}.png, 32x32 px per
                            tile, stacked [T*32, 32, C]; each invocation
                            APPENDS one revisit per covered tile (the
                            dataset reads any T and samples n_s2_images —
                            data/s2naip.py:169-197; frames need not be
                            chronological, README.md:108).
               role naip -> naip/{uuid}/{col}_{row}/rgb.png, 128x128 RGB
                            (README.md:96-100).
             Band value semantics follow README.md:102-106: `tci` and NAIP
             are 8-bit passthrough; every other band is 16-bit source
             divided by 8160, clipped to [0, 1], stored as 8-bit — so the
             training loader's /255 reproduces the normalized value.

Tile math: the 2^17 x 2^17 grid spans the Web-Mercator square
[-E, E]^2, E = 20037508.342789244 m, so one tile is 2E/2^17 = 305.748 m
= 32 px at 9.554629 m/px (Sentinel-2) = 128 px at 2.388657 m/px (NAIP).
Tile ids are `{col}_{row}` with col counting east from -E and row counting
south from +E (slippy-map orientation, zoom 17), matching the SatlasPretrain
convention the dataset references (README.md:93).

Only tiles FULLY covered by the input raster are emitted; a reprojection's
all-zero nodata border is skipped by default (--keep_blank emits it; the
training loader has its own black-pixel rejection semantics either way).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

# Half-extent of the Web-Mercator square, meters (EPSG:3857).
WEB_MERCATOR_E = 20037508.342789244
GRID = 1 << 17  # 2^17 x 2^17 tiles (README.md:100,112)
TILE_M = 2.0 * WEB_MERCATOR_E / GRID  # 305.748 m per tile side

S2_CHIP = 32
NAIP_CHIP = 128
S2_RES = TILE_M / S2_CHIP  # 9.554628535647032 m/px — the README's "9.555"
NAIP_RES = TILE_M / NAIP_CHIP  # 2.388657133911758 m/px

# README.md:112-113 band list; everything except tci is single-channel
# 16-bit source scaled by 1/8160 (README.md:106).
S2_BANDS = ("tci", "b01", "b05", "b06", "b07", "b08", "b09", "b10", "b11", "b12")


def tile_of(x_m: float, y_m: float) -> Tuple[int, int]:
    """(col, row) of the grid tile containing the EPSG:3857 point."""
    # +1e-9 tiles (~0.3 um) absorbs float error so an exact tile corner maps
    # to ITS tile, not the one left/above it
    col = int(np.floor((x_m + WEB_MERCATOR_E) / TILE_M + 1e-9))
    row = int(np.floor((WEB_MERCATOR_E - y_m) / TILE_M + 1e-9))
    return col, row


def tile_origin(col: int, row: int) -> Tuple[float, float]:
    """Top-left (x, y) meters of tile (col, row) — inverse of tile_of."""
    return (-WEB_MERCATOR_E + col * TILE_M, WEB_MERCATOR_E - row * TILE_M)


def normalize_band(arr: np.ndarray, band: str) -> np.ndarray:
    """Source pixel values -> the uint8 the S2-NAIP tree stores.

    tci / NAIP rgb: ESA/NAIP already deliver 8-bit 0-255 (README.md:104);
    pass through, refusing anything that is not already in range.
    Other bands: 16-bit source / 8160, clipped to [0,1], scaled to 0-255
    (README.md:106) — the loader's /255 then reproduces the normalized
    value at 8-bit quantization.
    """
    if band in ("tci", "rgb"):
        if arr.dtype == np.uint8:
            return arr
        a = np.asarray(arr)
        if a.min() < 0 or a.max() > 255:
            raise ValueError(
                f"band '{band}' is 8-bit passthrough; got {a.dtype} values "
                f"in [{a.min()}, {a.max()}] — reproject should not rescale "
                "TCI/NAIP")
        # round, don't truncate: bilinear reprojection delivers floats like
        # 254.9 that truncation would bias down a full DN
        return np.round(a).astype(np.uint8)
    a = np.clip(np.asarray(arr).astype(np.float64) / 8160.0, 0.0, 1.0)
    return np.round(a * 255.0).astype(np.uint8)


def read_raster(path: str, origin: Optional[Tuple[float, float]],
                res: Optional[float]):
    """-> (array [H,W,C], (origin_x, origin_y), res_m_per_px).

    .png/.npy need --origin (and use the role's resolution unless --res is
    given); GeoTIFF-family files read both from their transform via rasterio
    when it is available.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext in (".png",):
        from .utils.imgio import read_png

        arr = read_png(path)
    elif ext in (".npy",):
        arr = np.load(path)
        if arr.ndim == 2:
            arr = arr[..., None]
    else:
        try:
            import rasterio  # type: ignore
        except ImportError:
            raise SystemExit(
                f"prepare: reading {ext or path} needs rasterio, which is "
                "not installed here. Either `prepare reproject` the source "
                "on a machine with rasterio and export .npy/.png + --origin, "
                "or install rasterio.")
        with rasterio.open(path) as src:
            arr = np.moveaxis(src.read(), 0, -1)  # [C,H,W] -> [H,W,C]
            t = src.transform
            origin = (float(t.c), float(t.f))
            if abs(t.a) != abs(t.e):
                raise SystemExit(
                    f"prepare: {path} has anisotropic resolution "
                    f"({t.a} x {t.e}); reproject to a square grid first.")
            res = float(abs(t.a))
            if src.crs is not None and src.crs.to_epsg() != 3857:
                raise SystemExit(
                    f"prepare: {path} is in {src.crs}, not EPSG:3857 — run "
                    "`prepare reproject` first.")
    if origin is None:
        raise SystemExit(
            "prepare: --origin X,Y (top-left corner, EPSG:3857 meters) is "
            "required for png/npy inputs.")
    return np.ascontiguousarray(arr), (float(origin[0]), float(origin[1])), res


def covered_tiles(origin: Tuple[float, float], shape_hw: Tuple[int, int],
                  res: float) -> List[Tuple[int, int, int, int]]:
    """Tiles fully inside the raster -> [(col, row, px, py)] pixel offsets.

    Pixel offsets are rounded to the nearest integer; the raster is required
    to be grid-aligned to within 1% of a pixel per chip (a reprojection onto
    the exact target grid is, by construction).
    """
    ox, oy = origin
    h, w = shape_hw
    chip = int(round(TILE_M / res))
    # first tile whose full extent starts at or after the raster's top-left
    col0 = int(np.ceil((ox + WEB_MERCATOR_E) / TILE_M - 1e-9))
    row0 = int(np.ceil((WEB_MERCATOR_E - oy) / TILE_M - 1e-9))
    out = []
    col, row = col0, row0
    while True:
        tx, ty = tile_origin(col0, row)
        py = (oy - ty) / res
        if py + chip > h + 1e-6:
            break
        col = col0
        while True:
            tx, _ = tile_origin(col, row)
            px = (tx - ox) / res
            if px + chip > w + 1e-6:
                break
            ipx, ipy = int(round(px)), int(round(py))
            if abs(px - ipx) > 0.01 or abs(py - ipy) > 0.01:
                raise SystemExit(
                    f"prepare: raster is not aligned to the tile grid "
                    f"(tile {col}_{row} lands at fractional pixel "
                    f"({px:.3f}, {py:.3f})). The origin must sit on the "
                    f"{res:.9f} m/px pixel grid anchored at "
                    f"(-{WEB_MERCATOR_E}, +{WEB_MERCATOR_E}) — `prepare "
                    "reproject` snaps its output there for you.")
            out.append((col, row, ipx, ipy))
            col += 1
        row += 1
    return out


def _atomic_write_png(path: str, img: np.ndarray) -> None:
    from .utils.imgio import write_png

    tmp = f"{path}.tmp.{os.getpid()}"
    write_png(tmp, img)
    os.replace(tmp, path)


def chip_raster(arr: np.ndarray, origin: Tuple[float, float], res: float,
                out_root: str, role: str, band: str = "tci",
                uuid: str = "prepared", skip_blank: bool = True,
                overwrite: bool = False) -> dict:
    """Cut one reprojected raster into S2-NAIP tree chips. Returns a summary
    dict {written, appended, skipped_blank, tiles}."""
    from .utils.imgio import read_png

    chip = S2_CHIP if role == "s2" else NAIP_CHIP
    want_res = S2_RES if role == "s2" else NAIP_RES
    if abs(res - want_res) > want_res * 1e-3:
        raise SystemExit(
            f"prepare: role {role} expects {want_res:.6f} m/px, raster is "
            f"{res:.6f} — reproject at the role's resolution.")
    if role == "s2":
        if band not in S2_BANDS:
            raise SystemExit(
                f"prepare: unknown band {band!r} (S2-NAIP bands: "
                f"{', '.join(S2_BANDS)})")
        want_c = 3 if band == "tci" else 1
    else:
        band, want_c = "rgb", 3
    if arr.shape[-1] != want_c:
        raise SystemExit(
            f"prepare: band {band!r} stores {want_c} channel(s); raster has "
            f"{arr.shape[-1]}.")
    arr = normalize_band(arr, band)

    stats = {"written": 0, "appended": 0, "skipped_blank": 0, "tiles": []}
    for col, row, px, py in covered_tiles(origin, arr.shape[:2], res):
        patch = arr[py:py + chip, px:px + chip]
        if skip_blank and not patch.any():
            stats["skipped_blank"] += 1
            continue
        tile = f"{col}_{row}"
        if role == "s2":
            path = os.path.join(out_root, "sentinel2", tile, f"{band}.png")
            if os.path.exists(path):
                prev = read_png(path)
                if prev.shape[1] != chip or prev.shape[-1] != want_c:
                    raise SystemExit(
                        f"prepare: existing {path} has shape {prev.shape}, "
                        f"incompatible with a [{chip}, {chip}, {want_c}] "
                        "revisit append.")
                patch = np.concatenate([prev, patch], axis=0)
                stats["appended"] += 1
            else:
                stats["written"] += 1
            _atomic_write_png(path, patch)
        else:
            path = os.path.join(out_root, "naip", uuid, tile, "rgb.png")
            if os.path.exists(path) and not overwrite:
                raise SystemExit(
                    f"prepare: {path} exists (NAIP chips are single images, "
                    "not time series) — pass --overwrite to replace.")
            _atomic_write_png(path, patch)
            stats["written"] += 1
        stats["tiles"].append(tile)
    return stats


def snap_to_grid(ox: float, oy: float, width: int, height: int,
                 res: float) -> Tuple[float, float, int, int]:
    """Snap a north-up raster window to the dataset pixel grid.

    calculate_default_transform anchors the output at the source's
    reprojected bounds — an arbitrary origin that `chip` would refuse
    (covered_tiles requires pixel edges on the grid anchored at (-E, +E)).
    Returns (origin_x, origin_y, width, height) with the origin moved west/
    north by < 1 px onto the grid and the window grown to keep coverage,
    so reproject -> chip composes by construction (the equivalent of
    gdalwarp -tap).
    """
    # 1e-6 px epsilon: pixel indices here reach ~4e6, where double rounding
    # alone is ~1e-9 px — an already-aligned origin must be a fixed point,
    # and covered_tiles tolerates 0.01 px, so 1e-6 is safely in between
    sx = -WEB_MERCATOR_E + np.floor((ox + WEB_MERCATOR_E) / res + 1e-6) * res
    sy = WEB_MERCATOR_E - np.floor((WEB_MERCATOR_E - oy) / res + 1e-6) * res
    w = int(np.ceil((ox + width * res - sx) / res - 1e-6))
    h = int(np.ceil((sy - (oy - height * res)) / res - 1e-6))
    return float(sx), float(sy), w, h


_REPROJECT_RECIPE = """\
import numpy as np
import rasterio
from rasterio.transform import Affine
from rasterio.warp import calculate_default_transform, reproject, Resampling

E = 20037508.342789244  # snap to the S2-NAIP pixel grid anchored at (-E, +E)
with rasterio.open(SRC) as src:
    transform, width, height = calculate_default_transform(
        src.crs, 'EPSG:3857', src.width, src.height, *src.bounds,
        resolution=(RES, RES))
    sx = -E + np.floor((transform.c + E) / RES + 1e-6) * RES
    sy = E - np.floor((E - transform.f) / RES + 1e-6) * RES
    width = int(np.ceil((transform.c + width * RES - sx) / RES - 1e-6))
    height = int(np.ceil((sy - (transform.f - height * RES)) / RES - 1e-6))
    transform = Affine(RES, 0.0, sx, 0.0, -RES, sy)
    meta = src.meta.copy()
    meta.update(crs='EPSG:3857', transform=transform,
                width=width, height=height, driver='GTiff')
    with rasterio.open(DST, 'w', **meta) as dst:
        for b in range(1, src.count + 1):
            reproject(source=rasterio.band(src, b),
                      destination=rasterio.band(dst, b),
                      src_transform=src.transform, src_crs=src.crs,
                      dst_transform=transform, dst_crs='EPSG:3857',
                      resampling=Resampling.bilinear)"""


def reproject_raster(src_path: str, dst_path: str, res: float) -> None:
    """EPSG:3857 bilinear reproject at `res` m/px — the reference README's
    recipe (README.md:115-129), with the pseudo-code's bugs fixed (it uses
    `img`/`meta` before any read and never balances its open paren)."""
    try:
        import rasterio  # type: ignore
        from rasterio.warp import (  # type: ignore
            Resampling, calculate_default_transform, reproject)
    except ImportError:
        recipe = (_REPROJECT_RECIPE
                  .replace("SRC", repr(src_path))
                  .replace("DST", repr(dst_path))
                  .replace("RES", f"{res:.9f}"))
        raise SystemExit(
            "prepare reproject: rasterio is not installed in this "
            "environment (it is not a framework dependency). Run this "
            f"equivalent recipe where rasterio exists:\n\n{recipe}\n\n"
            "then feed the output back to `prepare chip`.")
    from rasterio.transform import Affine  # type: ignore

    with rasterio.open(src_path) as src:
        transform, width, height = calculate_default_transform(
            src.crs, "EPSG:3857", src.width, src.height, *src.bounds,
            resolution=(res, res))
        # snap onto the dataset pixel grid so `prepare chip` accepts the
        # output (covered_tiles alignment requirement)
        sx, sy, width, height = snap_to_grid(
            float(transform.c), float(transform.f), width, height, res)
        transform = Affine(res, 0.0, sx, 0.0, -res, sy)
        meta = src.meta.copy()
        meta.update(crs="EPSG:3857", transform=transform,
                    width=width, height=height, driver="GTiff")
        with rasterio.open(dst_path, "w", **meta) as dst:
            for b in range(1, src.count + 1):
                reproject(source=rasterio.band(src, b),
                          destination=rasterio.band(dst, b),
                          src_transform=src.transform, src_crs=src.crs,
                          dst_transform=transform, dst_crs="EPSG:3857",
                          resampling=Resampling.bilinear)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m satlas_sr_tpu_torch.prepare", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_re = sub.add_parser("reproject",
                          help="source raster -> EPSG:3857 GeoTIFF at the "
                               "S2-NAIP resolution (needs rasterio)")
    p_re.add_argument("src")
    p_re.add_argument("dst")
    p_re.add_argument("--role", choices=("s2", "naip"), default="s2",
                      help="picks the target resolution: s2 9.5546 m/px, "
                           "naip 2.3887 m/px")
    p_re.add_argument("--res", type=float, default=None,
                      help="override the target resolution (m/px)")

    p_ch = sub.add_parser("chip",
                          help="reprojected raster(s) -> S2-NAIP tree chips")
    p_ch.add_argument("--input", action="append", required=True,
                      help="raster (.png/.npy with --origin, or GeoTIFF via "
                           "rasterio); repeat to append multiple revisits "
                           "in order (s2 role)")
    p_ch.add_argument("--out", required=True, help="dataset root to write "
                      "sentinel2/ or naip/ under")
    p_ch.add_argument("--origin", default=None,
                      help="top-left corner 'X,Y' in EPSG:3857 meters "
                           "(required for png/npy inputs)")
    p_ch.add_argument("--res", type=float, default=None,
                      help="m/px for png/npy inputs (default: the role's)")
    p_ch.add_argument("--role", choices=("s2", "naip"), default="s2")
    p_ch.add_argument("--band", default="tci",
                      help=f"s2 band ({', '.join(S2_BANDS)}); naip is "
                           "always rgb")
    p_ch.add_argument("--uuid", default="prepared",
                      help="naip image_uuid directory component "
                           "(naip/{uuid}/{tile}/rgb.png)")
    p_ch.add_argument("--keep_blank", action="store_true",
                      help="emit all-zero (nodata) chips too")
    p_ch.add_argument("--overwrite", action="store_true",
                      help="replace existing NAIP chips")

    args = parser.parse_args(argv)
    if args.cmd == "reproject":
        res = args.res or (S2_RES if args.role == "s2" else NAIP_RES)
        reproject_raster(args.src, args.dst, res)
        print(f"reprojected {args.src} -> {args.dst} at {res:.6f} m/px")
        return 0

    origin = None
    if args.origin:
        x, y = args.origin.split(",")
        origin = (float(x), float(y))
    totals = {"written": 0, "appended": 0, "skipped_blank": 0}
    tiles: set = set()
    for path in args.input:
        arr, org, res = read_raster(path, origin, args.res)
        if res is None:
            res = S2_RES if args.role == "s2" else NAIP_RES
        stats = chip_raster(arr, org, res, args.out, args.role,
                            band=args.band, uuid=args.uuid,
                            skip_blank=not args.keep_blank,
                            overwrite=args.overwrite)
        for k in totals:
            totals[k] += stats[k]
        tiles.update(stats["tiles"])
    print(json.dumps({"role": args.role, "band": args.band,
                      "inputs": len(args.input), "tiles": len(tiles),
                      **totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

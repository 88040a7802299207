"""Host-side formatting for GT-free inference.

A flat [T*32, 32, 3] PNG becomes frames; frames are split good/bad by the
inference black-frame predicate (ANY zero element, the reference's numpy
`[0,0,0] in ts` semantics); n frames are sampled good-first and
channel-stacked into the model input. A batch of PNGs becomes one uint8
[B, 32, 32, T*3] array, decoded in one native call (`read_png_many`);
normalisation happens on the device.

Also here: the tile helpers of infer_grid (`assemble_tile`, `stitch`) and
the multi-band helpers (`s2_bands`: tci first, 3 channels, every other band
1 channel, a missing band zero-filled). The frame RNG of every chip is
np.random.RandomState(seed + its global corpus index) everywhere.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .imgio import read_png, write_png
from .native_png import read_png_many

DECODE_THREADS = 4


def select_frames(frame_is_bad: np.ndarray, n_images: int,
                  rng: np.random.RandomState) -> List[int]:
    """Pick n frame indices, sampling valid frames first (reference policy)."""
    goods = [i for i, bad in enumerate(frame_is_bad) if not bad]
    bads = [i for i, bad in enumerate(frame_is_bad) if bad]
    if len(goods) >= n_images:
        idx = rng.choice(len(goods), size=n_images, replace=False)
        return [goods[i] for i in idx]
    need = n_images - len(goods)
    extra = rng.choice(len(bads), size=need, replace=False)
    return goods + [bads[i] for i in extra]


def format_s2naip_data(s2_data: np.ndarray, n_s2_images: int,
                       rng: Optional[np.random.RandomState] = None) -> Tuple[np.ndarray, np.ndarray]:
    """[T*32, 32, 3] uint8 -> ([32, 32, n*3] uint8 channel-stacked, first frame)."""
    rng = rng or np.random.RandomState(0)
    chunks = s2_data.reshape(-1, 32, 32, 3)
    preview = chunks[0]
    frame_is_bad = (chunks == 0).any(axis=(1, 2, 3))
    indices = select_frames(frame_is_bad, n_s2_images, rng)
    return np.concatenate(list(chunks[indices]), axis=-1), preview


def decode_many(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode PNG files: one native call for all, PIL (on DECODE_THREADS
    threads) for what the native codec could not read or when it is absent."""
    decoded = read_png_many(list(paths)) or [None] * len(paths)
    missing = [k for k, arr in enumerate(decoded) if arr is None]
    if missing:
        with ThreadPoolExecutor(max_workers=DECODE_THREADS) as pool:
            for k, arr in zip(missing, pool.map(read_png, [paths[k] for k in missing])):
                decoded[k] = arr
    return decoded


def format_s2naip_batch(pngs: Sequence[str], n_s2_images: int, seed: int = 0,
                        indices: Optional[Sequence[int]] = None) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Decode and format many PNGs into one [B, 32, 32, n*3] uint8 batch.

    The frame-selection RNG of image i is np.random.RandomState(seed + gi),
    gi its GLOBAL corpus index (indices[i], or i), so a corpus formats the
    same however it is batched or filtered.
    """
    results = [format_s2naip_data(arr, n_s2_images,
                                  np.random.RandomState(seed + (indices[i] if indices is not None else i)))
               for i, arr in enumerate(decode_many(pngs))]
    return np.stack([r[0] for r in results]), [r[1] for r in results]


def assemble_tile(tile_dir: str, n_s2_images: int, seed: int = 0, grid_size: int = 16,
                  index_map: Optional[dict] = None,
                  rows: Optional[Tuple[int, int]] = None) -> Tuple[np.ndarray, np.ndarray]:
    """A tile's {i}_{j}.png chunk grid -> ONE whole-tile input.

    Each 32x32 chunk's frames are selected as format_s2naip_data does and
    placed at (i*32, j*32) of a [grid*32, grid*32, n*3] canvas. Returns
    (canvas, preview), preview being each chunk's first frame (the
    stitched_s2.png of the tile). `index_map` (path -> global corpus index)
    seeds each chunk's RNG as the chunked CLI does; without it the in-tile
    index seeds it. `rows` = (start, stop) returns only those canvas and
    preview rows, decoding only the chunk rows they cross (a rank's band of
    a row-sharded tile); each chunk keeps its seed.
    """
    size = grid_size * 32
    r0, r1 = rows if rows is not None else (0, size)
    keys = [(i, j) for i in range(r0 // 32, -(-r1 // 32)) for j in range(grid_size)]
    paths = [os.path.join(tile_dir, f"{i}_{j}.png") for i, j in keys]
    canvas = np.zeros((r1 - r0, size, 3 * n_s2_images), np.uint8)
    preview = np.zeros((r1 - r0, size, 3), np.uint8)
    for (i, j), path, arr in zip(keys, paths, decode_many(paths)):
        idx = index_map[path] if index_map is not None else i * grid_size + j
        stacked, first = format_s2naip_data(arr, n_s2_images, np.random.RandomState(seed + idx))
        lo, hi = max(i * 32, r0), min((i + 1) * 32, r1)
        canvas[lo - r0:hi - r0, j * 32:(j + 1) * 32] = stacked[lo - i * 32:hi - i * 32]
        preview[lo - r0:hi - r0, j * 32:(j + 1) * 32] = first[lo - i * 32:hi - i * 32]
    return canvas, preview


def stitch(chunks_dir: str, img_size: int, save_path: str, grid_size: int = 16,
           sentinel2: bool = False) -> None:
    """Assemble {i}_{j}.png chunks for i, j in [0, grid_size) into one image
    (for sentinel2 chunks, each chunk's first frame)."""
    chunk = img_size // grid_size
    paths = [os.path.join(chunks_dir, f"{i}_{j}.png") for i in range(grid_size) for j in range(grid_size)]
    canvas = np.zeros((img_size, img_size, 3), dtype=np.uint8)
    for k, tile in enumerate(decode_many(paths)):
        if sentinel2:
            tile = tile.reshape(-1, 32, 32, 3)[0]
        i, j = divmod(k, grid_size)
        canvas[i * chunk:(i + 1) * chunk, j * chunk:(j + 1) * chunk] = tile
    write_png(save_path, canvas)


def normalize_bands(s2_bands) -> List[str]:
    """Band list with tci forced to the front (the training loader's rule)."""
    bands = [str(b) for b in (s2_bands or ["tci"])]
    if "tci" in bands:
        bands.remove("tci")
    return ["tci"] + bands


def channels_per_frame(s2_bands) -> int:
    """Per-frame channel count for a band list: tci carries 3, others 1."""
    return 2 + len(normalize_bands(s2_bands))


def load_band_stack(chip_dir: str, bands: Sequence[str]) -> np.ndarray:
    """Dataset-layout chip dir ({chip_dir}/{band}.png) -> [T, 32, 32, C_total].

    tci is 3-channel and REQUIRED, other bands are 1-channel, a missing band
    file zero-fills at tci's frame count. A band whose frame count differs
    from tci's raises: GT-free inference has no next chip to move on to.
    """
    tci_path = os.path.join(chip_dir, "tci.png")
    tci = read_png(tci_path)  # raises when missing/undecodable
    if tci.shape[0] % 32 != 0 or tci.shape[1] != 32 or tci.shape[-1] != 3:
        raise ValueError(f"{tci_path}: expected [T*32, 32, 3], got {tci.shape}")
    n_frames = tci.shape[0] // 32
    per_band = [tci.reshape(n_frames, 32, 32, 3)]
    for band in bands:
        if band == "tci":
            continue
        path = os.path.join(chip_dir, f"{band}.png")
        if not os.path.exists(path):
            per_band.append(np.zeros((n_frames, 32, 32, 1), np.uint8))
            continue
        img = read_png(path)
        if img.shape[0] % 32 != 0 or img.shape[1] != 32:
            raise ValueError(f"{path}: expected [T*32, 32, C], got {img.shape}")
        if img.shape[0] // 32 != n_frames:
            raise ValueError(f"{path}: {img.shape[0] // 32} frames but tci has {n_frames}")
        per_band.append(img.reshape(n_frames, 32, 32, img.shape[-1]))
    return np.concatenate(per_band, axis=-1)


def format_s2naip_multiband(chip_dir: str, bands: Sequence[str], n_s2_images: int,
                            rng: Optional[np.random.RandomState] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Chip dir -> ([32, 32, n*C_total] channel-stacked uint8, tci preview).

    Frame goodness is judged on tci with the inference predicate; the
    selected frames carry all bands.
    """
    rng = rng or np.random.RandomState(0)
    stack = load_band_stack(chip_dir, bands)
    frame_is_bad = (stack[..., :3] == 0).any(axis=(1, 2, 3))
    indices = select_frames(frame_is_bad, n_s2_images, rng)
    return np.concatenate(list(stack[indices]), axis=-1), stack[0, ..., :3]


def format_s2naip_multiband_batch(chip_dirs: Sequence[str], bands: Sequence[str], n_s2_images: int,
                                  seed: int = 0, indices: Optional[Sequence[int]] = None
                                  ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Many chip dirs -> ([B, 32, 32, n*C_total] uint8, tci previews), with
    format_s2naip_batch's global-index RNG seeding."""
    results = [format_s2naip_multiband(d, bands, n_s2_images,
                                       np.random.RandomState(seed + (indices[i] if indices is not None else i)))
               for i, d in enumerate(chip_dirs)]
    return np.stack([r[0] for r in results]), [r[1] for r in results]

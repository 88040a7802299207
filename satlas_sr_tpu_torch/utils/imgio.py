"""PNG read/write for the host side. Images are uint8 HWC: RGB, or HW1 for gray.

The port's native codec (utils/native_png.py, csrc/pngio.cpp, on zlib alone)
runs first; PIL takes over where the codec is not built (no g++ or no zlib
header), for an interlaced file, which the codec does not decode, and for a
file that fails to decode natively, where it raises PIL's own error. Both paths
give the same pixels: gray -> HW1, alpha dropped (palette + tRNS -> RGB),
16-bit -> the high byte. `codec()` names the path files take.
"""

from __future__ import annotations

import os

import numpy as np

from . import native_png


def codec() -> str:
    """'native' when the port's codec is built and loaded, else 'pil'."""
    return "native" if native_png.available() else "pil"


def _pil_decode(src) -> np.ndarray:
    from PIL import Image

    with Image.open(src) as im:
        # PIL opens 16-bit gray + alpha as RGBA; its raw mode still says LA
        gray_alpha = bool(im.tile) and str(im.tile[0][3]).startswith("LA")
        if im.mode.startswith("I"):  # 16-bit gray ("I;16", "I"): keep the high byte
            arr = (np.asarray(im).astype(np.uint32) >> 8).astype(np.uint8)
        elif im.mode in ("1", "L", "LA") or gray_alpha:
            arr = np.asarray(im.convert("L") if im.mode == "1" else im.getchannel(0))
        else:
            arr = np.asarray(im if im.mode in ("RGB", "RGBA") else im.convert("RGBA"))[..., :3]
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.ascontiguousarray(arr)


def read_png(path: str) -> np.ndarray:
    """Read a PNG into an HWC uint8 array (grayscale -> HW1, alpha dropped)."""
    arr = native_png.read_png(path)
    return arr if arr is not None else _pil_decode(path)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an HWC uint8 array as a PNG (creates parent dirs)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not native_png.write_png(path, img):
        from PIL import Image

        Image.fromarray(img[..., 0] if img.ndim == 3 and img.shape[-1] == 1 else img).save(path)

"""PNG read/write for the host side. Images are uint8 HWC: RGB, or HW1 for gray.

The port's native codec (utils/native_png.py, csrc/pngio.cpp, on zlib alone)
runs first; PIL takes over where the codec is not built (no g++ or no zlib
header), for an interlaced file, which the codec does not decode, and for a
file that fails to decode natively, where it raises PIL's own error. Both paths
give the same pixels: gray -> HW1, alpha dropped (palette + tRNS -> RGB),
16-bit -> the high byte. `codec()` names the path files take.
`read_png_bytes` / `encode_png_bytes` do the same for in-memory bytes (the
serving daemon's requests and responses).
"""

from __future__ import annotations

import os

import numpy as np

from . import native_png


def codec() -> str:
    """'native' when the port's codec is built and loaded, else 'pil'."""
    return "native" if native_png.available() else "pil"


def _pil_decode(src, max_pixels: int = 0) -> np.ndarray:
    from PIL import Image

    with Image.open(src) as im:
        if max_pixels and im.size[0] * im.size[1] > max_pixels:  # header only
            raise native_png.ImageTooLarge(f"image {im.size} exceeds {max_pixels} pixel limit")
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


def read_png_bytes(data: bytes, max_pixels: int = 0) -> np.ndarray:
    """Decode in-memory PNG bytes (a serving request) to HWC uint8, with the
    channel rules of `read_png`. `max_pixels > 0` is checked from the header,
    before any pixel is inflated (a 16 MB body can inflate to gigabytes):
    native_png.ImageTooLarge, a ValueError, when it is exceeded."""
    arr = native_png.decode_png_bytes(data, max_pixels=max_pixels)
    if arr is not None:
        return arr
    import io

    return _pil_decode(io.BytesIO(data), max_pixels)


def encode_png_bytes(img: np.ndarray) -> bytes:
    """Encode HWC uint8 (1 or 3 channels) as PNG bytes: the native codec at
    zlib level 1 (a response is transient, not an archive), PIL where the
    codec is absent."""
    out = native_png.encode_png_bytes(img)
    if out is not None:
        return out
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if img.ndim == 3 and img.shape[-1] == 1 else img).save(
        buf, format="PNG")
    return buf.getvalue()


def write_png(path: str, img: np.ndarray) -> None:
    """Write an HWC uint8 array as a PNG (creates parent dirs)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not native_png.write_png(path, img):
        from PIL import Image

        Image.fromarray(img[..., 0] if img.ndim == 3 and img.shape[-1] == 1 else img).save(path)

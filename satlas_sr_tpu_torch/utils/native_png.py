"""ctypes bindings for the port's native PNG codec (csrc/pngio.cpp, on zlib
alone: no libpng).

The source compiles with g++ (`-lz`) into
`build/host/libpngio-<hash>.so` at the root of the checkout, <hash> taken over
the source and the flags (as ops/cuda/build.py does for nvcc), the first time
a caller needs it; nothing is built at import. Decode and encode run in C with
the GIL released (ctypes drops it for the call), and `read_png_many` decodes a
whole batch of files on a C++ thread pool in one call.

`available()` says whether the codec built and loaded; `lib()` raises with the
compiler's output when it did not. The functions below return None (False for
`write_png`) when the codec is unavailable or a file fails to decode, so the
caller (utils/imgio.py) can fall back to PIL. Adam7-interlaced files are one
such case: the codec does not decode them, and `interlaced_count()` says how
many it has handed back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pngio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
LINK_FLAGS = ["-lz", "-pthread"]
INTERLACED = 7  # pngio.cpp's return code for an Adam7 file

_lock = threading.Lock()
_state: dict = {"interlaced": 0}  # + "lib": CDLL, "path": Path, or "error": str


class ImageTooLarge(ValueError):
    """Decode refused: the PNG header announces more than max_pixels pixels."""


def zlib_present() -> bool:
    """True when g++ finds zlib's header (the codec should then build)."""
    try:
        proc = subprocess.run(["g++", "-x", "c++", "-E", "-", "-o", os.devnull],
                              input="#include <zlib.h>\n", capture_output=True, text=True)
    except FileNotFoundError:
        return False
    return proc.returncode == 0


def library_path() -> Path:
    """Where the codec for the current source and flags is (or would be) built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpngio-{digest}.so"


def _build() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one build at a time across processes (test workers share the checkout)
    with open(BUILD_DIR / ".pngio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"no host C++ compiler to build pngio.cpp: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for pngio.cpp (exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    i, p, ip, vpp = ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    lib.pngio_read.argtypes = [ctypes.c_char_p, ip, ip, ip, vpp]
    lib.pngio_read_many.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, ip, ip, ip, vpp, ip, i]
    lib.pngio_write.argtypes = [ctypes.c_char_p, p, i, i, i]
    lib.pngio_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_longlong, ip, ip, ip, vpp]
    lib.pngio_encode.argtypes = [p, i, i, i, i, vpp, ctypes.POINTER(ctypes.c_size_t)]
    for fn in (lib.pngio_read, lib.pngio_read_many, lib.pngio_write, lib.pngio_decode,
               lib.pngio_encode):
        fn.restype = ctypes.c_int
    lib.pngio_free.argtypes = [p]
    lib.pngio_free.restype = None


def lib() -> ctypes.CDLL:
    """The loaded codec, built on first use; raises RuntimeError (with the
    compiler's output) when it cannot be built or loaded."""
    with _lock:
        if "lib" not in _state and "error" not in _state:
            try:
                path = _build()
                handle = ctypes.CDLL(str(path))
                _bind(handle)
                _state.update(lib=handle, path=path)
            except (RuntimeError, OSError) as e:
                _state["error"] = str(e)
        if "error" in _state:
            raise RuntimeError(_state["error"])
        return _state["lib"]


def available() -> bool:
    try:
        lib()
    except RuntimeError:
        return False
    return True


def loaded_path() -> Optional[Path]:
    """Path of the loaded codec library, or None before a successful load."""
    return _state.get("path")


def interlaced_count() -> int:
    """How many interlaced files the codec has handed back undecoded."""
    return _state["interlaced"]


def _count(rc: int) -> None:
    if rc == INTERLACED:
        with _lock:
            _state["interlaced"] += 1


def _take(handle, buf, h: int, w: int, c: int) -> np.ndarray:
    """Copy a malloc'd H*W*C buffer out of the codec and free it."""
    try:
        n = h * w * c
        arr = np.ctypeslib.as_array(ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), shape=(n,)).copy()
    finally:
        handle.pngio_free(buf)
    return arr.reshape(h, w, c)


def read_png(path: str) -> Optional[np.ndarray]:
    """Decode a PNG file to HWC uint8, or None (codec unavailable, bad file)."""
    if not available():
        return None
    handle = lib()
    h, w, c, buf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_void_p()
    rc = handle.pngio_read(os.fsencode(path), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                           ctypes.byref(buf))
    if rc != 0:
        _count(rc)
        return None
    return _take(handle, buf, h.value, w.value, c.value)


def read_png_many(paths, n_threads: int = 0) -> Optional[List[Optional[np.ndarray]]]:
    """Decode many PNG files in one native call on a C++ thread pool.

    Returns one HWC uint8 array per path (None for a file that failed), or
    None when the codec is unavailable. `n_threads` <= 0 takes
    min(8, max(2, 2 * cores)).
    """
    if not available():
        return None
    n = len(paths)
    if n == 0:
        return []
    if n_threads <= 0:
        n_threads = min(8, max(2, (os.cpu_count() or 1) * 2))
    handle = lib()
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    hs, ws, cs, rcs = ((ctypes.c_int * n)() for _ in range(4))
    bufs = (ctypes.c_void_p * n)()
    handle.pngio_read_many(c_paths, n, hs, ws, cs, bufs, rcs, n_threads)
    for rc in rcs:
        _count(rc)
    return [_take(handle, bufs[k], hs[k], ws[k], cs[k]) if rcs[k] == 0 and bufs[k] else None
            for k in range(n)]


def decode_png_bytes(data: bytes, max_pixels: int = 0) -> Optional[np.ndarray]:
    """Decode in-memory PNG bytes to HWC uint8, or None (codec unavailable or
    bytes malformed). Raises ImageTooLarge, from the header and before any
    pixel is decompressed, when max_pixels > 0 is exceeded."""
    if not available():
        return None
    handle = lib()
    h, w, c, buf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_void_p()
    rc = handle.pngio_decode(data, len(data), max_pixels, ctypes.byref(h), ctypes.byref(w),
                             ctypes.byref(c), ctypes.byref(buf))
    if rc == 6:
        raise ImageTooLarge(f"image ({w.value}, {h.value}) exceeds {max_pixels} pixel limit")
    _count(rc)
    if rc != 0 or not buf:
        return None
    return _take(handle, buf, h.value, w.value, c.value)


def _hwc(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return img[..., None] if img.ndim == 2 else img


def encode_png_bytes(img: np.ndarray, level: int = 1) -> Optional[bytes]:
    """Encode HWC uint8 (1 or 3 channels) to PNG bytes at zlib `level`, or None."""
    if not available():
        return None
    handle = lib()
    img = _hwc(img)
    h, w, c = img.shape
    buf, n = ctypes.c_void_p(), ctypes.c_size_t()
    if handle.pngio_encode(img.ctypes.data, h, w, c, level, ctypes.byref(buf),
                           ctypes.byref(n)) != 0 or not buf:
        return None
    try:
        return ctypes.string_at(buf, n.value)
    finally:
        handle.pngio_free(buf)


def write_png(path: str, img: np.ndarray) -> bool:
    """Write HWC uint8 (1 or 3 channels) as a PNG at zlib level 1; False when
    the codec is unavailable or the write failed."""
    if not available():
        return False
    img = _hwc(img)
    h, w, c = img.shape
    return lib().pngio_write(os.fsencode(path), img.ctypes.data, h, w, c) == 0

"""The port's native PNG codec (csrc/pngio.cpp on zlib alone, utils/native_png.py)
against PIL and the JAX package's codec.

The codec is built here with g++ at first use; these tests skip only where
zlib's header is absent. Decoded pixels must equal PIL's (after the port's
normalisation: gray -> HW1, gray < 8 bits scaled to 0..255, alpha dropped,
palette + tRNS -> RGB, 16-bit -> high byte) and the JAX package's native_png
bit for bit, on files and on bytes: files PIL writes, and files built here
with zlib for every colour type and bit depth, each row under one of the
five filters. Encode -> decode round-trips; interlaced files are handed back
undecoded (and counted) for PIL to read; malformed bytes decode to None
without a word on stderr, as tests/test_imgio.py requires of the JAX codec.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from satlas_sr_tpu.utils import native_png as jax_native_png
from satlas_sr_tpu_torch.utils import imgio, native_png
from torch_threads import two_torch_threads  # noqa: F401

RNG = np.random.RandomState(7)


@pytest.fixture(scope="module")
def codec():
    if not native_png.zlib_present():
        pytest.skip("zlib's header (zlib.h) is not installed: the codec cannot build")
    native_png.lib()  # builds; raises with g++'s output if it fails
    return native_png


def _pil_png(img, **save) -> bytes:
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, format="PNG", **save)
    return buf.getvalue()


def _palette():
    return Image.fromarray((RNG.rand(16, 16, 3) * 255).astype(np.uint8)).quantize(32)


def _cases():
    g16 = (RNG.rand(12, 12) * 65535).astype(np.uint16)
    rgba = (RNG.rand(24, 24, 4) * 255).astype(np.uint8)
    rgb = (RNG.rand(40, 24, 3) * 255).astype(np.uint8)
    gray = (RNG.rand(17, 33) * 255).astype(np.uint8)
    pal = _palette()
    return {
        "rgb": (_pil_png(rgb), rgb),
        "gray": (_pil_png(gray), gray[..., None]),
        "rgba": (_pil_png(rgba), rgba[..., :3]),
        "palette_trns": (_pil_png(pal, transparency=0), np.asarray(pal.convert("RGBA"))[..., :3]),
        "gray16": (_pil_png(g16), (g16 >> 8).astype(np.uint8)[..., None]),
    }


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Filter each byte row with filter (row index % 5): None, Sub, Up,
    Average, Paeth, so every file built here carries all five."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = y % 5
        pred = [0, a, prev, (a + prev) // 2, _paeth(a, prev, c)][f]
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[H, W*spp] samples -> [H, stride] bytes at `depth` bits (big-endian)."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    h, n = samples.shape
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = samples
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
    return (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _png(samples, color_type, depth, plte=None, trns=None, interlace=0) -> bytes:
    """A PNG built here: samples [H, W, spp] at `depth` bits, rows filtered by
    _filter_rows (or, interlaced, the seven Adam7 passes unfiltered)."""
    h, w, spp = samples.shape
    bpp = max(1, spp * depth // 8)
    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                  (1, 0, 2, 2), (0, 1, 1, 2))
        raw = b""
        for x0, y0, dx, dy in passes:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                rows = _pack(sub.reshape(sub.shape[0], -1), depth)
                raw += b"".join(b"\0" + r.tobytes() for r in rows)
    else:
        raw = _filter_rows(_pack(samples.reshape(h, -1), depth), bpp)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                                                   0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(raw, 6)
    # the image data split over several IDAT chunks
    for k in range(0, len(z), max(1, len(z) // 3)):
        out += _chunk(b"IDAT", z[k:k + max(1, len(z) // 3)])
    return out + _chunk(b"IEND", b"")


def _built_cases():
    """Every colour type and bit depth, with the 8-bit values each must decode to."""
    cases = {}
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
    depths = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
    for ct, ds in depths.items():
        for d in ds:
            h, w = 11, 13  # odd sizes: partial bytes at the row's end for d < 8
            samples = RNG.randint(0, 1 << d, size=(h, w, spp[ct])).astype(np.int64)
            plte = trns = None
            if ct == 3:
                plte = RNG.randint(0, 256, size=(1 << d, 3))
                want = plte[samples[..., 0]]
                trns = bytes(RNG.randint(0, 256, size=(1 << d) // 2 + 1).astype(np.uint8))
            elif d == 16:
                want = samples >> 8
            else:
                want = samples * (255 // ((1 << d) - 1))
            if ct in (4, 6):
                want = want[..., :-1]  # alpha dropped
            cases[f"ct{ct}_d{d}"] = (_png(samples, ct, d, plte, trns), want.astype(np.uint8))
    gray = RNG.randint(0, 256, size=(9, 10, 1))
    cases["gray_trns"] = (_png(gray, 0, 8, trns=b"\x00\x07"), gray.astype(np.uint8))
    return cases


CASES = {**_cases(), **_built_cases()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_pil_and_jax_codec(codec, tmp_path, name):
    data, want = CASES[name]
    path = tmp_path / f"{name}.png"
    path.write_bytes(data)
    got = codec.read_png(str(path))
    assert got is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(codec.decode_png_bytes(data), want)
    np.testing.assert_array_equal(imgio._pil_decode(str(path)), want)  # the PIL fallback
    np.testing.assert_array_equal(codec.read_png_many([str(path)])[0], want)
    if jax_native_png.available():
        np.testing.assert_array_equal(got, jax_native_png.read_png(str(path)))


def test_built_cases_cover_every_type_depth_and_filter():
    built = {k for k in CASES if k.startswith("ct")}
    assert len(built) == 5 + 2 + 4 + 2 + 2
    filters = set()
    for name in built:
        data = CASES[name][0]
        rows = zlib.decompress(b"".join(
            data[i + 8:i + 8 + struct.unpack(">I", data[i:i + 4])[0]]
            for i in _chunk_offsets(data) if data[i + 4:i + 8] == b"IDAT"))
        h = struct.unpack(">I", data[20:24])[0]
        stride = len(rows) // h
        filters |= {rows[y * stride] for y in range(h)}
    assert filters == {0, 1, 2, 3, 4}


def _chunk_offsets(data):
    i = 8
    while i < len(data):
        yield i
        i += 12 + struct.unpack(">I", data[i:i + 4])[0]


@pytest.mark.parametrize("ct,spp", [(2, 3), (0, 1)])
def test_interlaced_is_handed_to_pil(codec, tmp_path, ct, spp):
    img = RNG.randint(0, 256, size=(13, 11, spp))
    data = _png(img, ct, 8, interlace=1)
    path = tmp_path / "adam7.png"
    path.write_bytes(data)
    before = codec.interlaced_count()
    assert codec.read_png(str(path)) is None
    assert codec.decode_png_bytes(data) is None
    assert codec.read_png_many([str(path)]) == [None]
    assert codec.interlaced_count() == before + 3
    np.testing.assert_array_equal(imgio.read_png(str(path)), img.astype(np.uint8))


def test_codec_needs_no_libpng():
    assert not any("png" in flag for flag in native_png.LINK_FLAGS)
    assert "-lz" in native_png.LINK_FLAGS
    assert "png.h" not in native_png.SOURCE.read_text()
    assert "zlib.h" in native_png.SOURCE.read_text()


def test_encoder_filters_keep_files_small(codec):
    # a smooth image: the row filters, not deflate alone, make it small
    y, x = np.mgrid[0:256, 0:256]
    img = np.stack([x, y, (x + y) // 2], -1).astype(np.uint8)
    ours = codec.encode_png_bytes(img, level=1)
    pil = _pil_png(img, compress_level=1)
    raw = zlib.compress(b"".join(b"\0" + r.tobytes() for r in img.reshape(256, -1)), 1)
    assert len(ours) < 0.5 * len(raw)
    assert len(ours) <= 1.25 * len(pil), (len(ours), len(pil))


@pytest.mark.parametrize("shape", [(96, 64, 3), (40, 56, 1), (40, 56)])
def test_encode_roundtrips_and_pil_reads_it(codec, tmp_path, shape):
    img = (RNG.rand(*shape) * 255).astype(np.uint8)
    want = img if img.ndim == 3 else img[..., None]
    for level in (1, 9):
        data = codec.encode_png_bytes(img, level=level)
        np.testing.assert_array_equal(codec.decode_png_bytes(data), want)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))).reshape(want.shape), want)
    path = str(tmp_path / "sub" / "x.png")
    imgio.write_png(path, img)
    np.testing.assert_array_equal(imgio.read_png(path), want)
    if jax_native_png.available():
        np.testing.assert_array_equal(jax_native_png.read_png(path), want)


def test_read_many_marks_failed_files(codec, tmp_path):
    good = tmp_path / "good.png"
    imgio.write_png(str(good), np.zeros((8, 8, 3), np.uint8))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    out = codec.read_png_many([str(good), str(tmp_path / "bad.png"), str(tmp_path / "none.png")])
    assert out[0].shape == (8, 8, 3) and out[1] is None and out[2] is None


def test_malformed_bytes_decode_to_none_silently(codec, capfd, tmp_path):
    good = codec.encode_png_bytes(np.zeros((8, 8, 3), np.uint8))
    assert codec.decode_png_bytes(good[:20]) is None
    assert codec.decode_png_bytes(b"not a png at all") is None
    assert "libpng" not in capfd.readouterr().err
    # through imgio, a file the codec cannot read reaches PIL, which raises
    bad = tmp_path / "truncated.png"
    bad.write_bytes(good[:20])
    with pytest.raises(OSError):
        imgio.read_png(str(bad))


def test_corrupt_chunks_are_refused(codec):
    data = bytearray(CASES["rgb"][0])
    data[40] ^= 0xFF  # inside IHDR's or IDAT's body: the CRC no longer matches
    assert codec.decode_png_bytes(bytes(data)) is None
    no_plte = _png(RNG.randint(0, 4, size=(4, 4, 1)), 3, 2)  # palette type without PLTE
    assert codec.decode_png_bytes(no_plte) is None
    short = _png(RNG.randint(0, 256, size=(8, 8, 3)), 2, 8)
    iend = short.rindex(b"IEND") - 4
    idat = short.index(b"IDAT") - 4
    n = struct.unpack(">I", short[idat:idat + 4])[0]
    # the first IDAT chunk alone: too little image data
    assert codec.decode_png_bytes(short[:idat + 12 + n] + short[iend:]) is None


def test_max_pixels_is_checked_before_decode(codec):
    data = codec.encode_png_bytes(np.zeros((128, 128, 3), np.uint8))
    with pytest.raises(native_png.ImageTooLarge, match="pixel limit"):
        codec.decode_png_bytes(data, max_pixels=100)
    assert codec.decode_png_bytes(data, max_pixels=128 * 128).shape == (128, 128, 3)


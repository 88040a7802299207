"""The port's native PNG codec (csrc/pngio.cpp, utils/native_png.py) against
PIL and the JAX package's codec.

The codec is built here with g++ at first use; these tests skip only where
libpng's header is absent. Decoded pixels must equal PIL's (after the port's
normalisation: gray -> HW1, alpha dropped, palette + tRNS -> RGB, 16-bit ->
high byte) and the JAX package's native_png bit for bit, on files and on
bytes; encode -> decode round-trips; malformed bytes decode to None without
a word on stderr, as tests/test_imgio.py requires of the JAX codec.
"""

import io

import numpy as np
import pytest
from PIL import Image

from satlas_sr_tpu.utils import native_png as jax_native_png
from satlas_sr_tpu_torch.utils import imgio, native_png

RNG = np.random.RandomState(7)


@pytest.fixture(scope="module")
def codec():
    if not native_png.libpng_present():
        pytest.skip("libpng's header (png.h) is not installed: the codec cannot build")
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


CASES = _cases()


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


def test_max_pixels_is_checked_before_decode(codec):
    data = codec.encode_png_bytes(np.zeros((128, 128, 3), np.uint8))
    with pytest.raises(native_png.ImageTooLarge, match="pixel limit"):
        codec.decode_png_bytes(data, max_pixels=100)
    assert codec.decode_png_bytes(data, max_pixels=128 * 128).shape == (128, 128, 3)


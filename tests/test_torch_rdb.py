"""The port's ResidualDenseBlock op against the JAX package's.

On the CPU the `rdb` wrapper runs its plain version; it is held against the
Pallas kernel in interpret mode and against the literal conv chain
(ResidualDenseBlock(fused=False)), at the tolerances of test_pallas_rdb.py:
the same f32 math, only the summation order differs. The CUDA kernel is held
against the plain version on the card by test_torch_cuda_kernels.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs.rrdbnet import ResidualDenseBlock as JaxRDB
from satlas_sr_tpu.ops.pallas.rdb import rdb_pallas
from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
from satlas_sr_tpu_torch.ops.cuda.rdb import pack_weights, packed_shape, rdb


def _jax_block(rng, nf, g, batch=2, hw=16):
    x = rng.randn(batch, hw, hw, nf).astype(np.float32)
    m = JaxRDB(nf, g, fused=False)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(np.asarray, v["params"])
    kernels = [p[f"conv{i + 1}"]["kernel"] for i in range(5)]
    # non-zero biases, so the bias wiring is checked too
    biases = [rng.randn(*p[f"conv{i + 1}"]["bias"].shape).astype(np.float32) * 0.1
              for i in range(5)]
    for i in range(5):
        v["params"][f"conv{i + 1}"]["bias"] = jnp.asarray(biases[i])
    return x, m, v, kernels, biases


def _torch_weights(kernels, biases):
    """HWIO -> OIHW, as rrdbnet_from_jax converts them."""
    return ([torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))) for k in kernels],
            [torch.from_numpy(b) for b in biases])


@pytest.mark.parametrize("nf,g", [(64, 32), (16, 8)])
def test_rdb_cpu_matches_pallas_interpret_and_conv_chain(rng, nf, g):
    x, m, v, kernels, biases = _jax_block(rng, nf, g)
    y_chain = np.asarray(m.apply(v, jnp.asarray(x)))
    y_pal = np.asarray(rdb_pallas(jnp.asarray(x), [jnp.asarray(k) for k in kernels],
                                  [jnp.asarray(b) for b in biases], nf, g, tile=2,
                                  interpret=True))
    tk, tb = _torch_weights(kernels, biases)
    before = rdb_mod.LAUNCHES
    y = rdb(torch.from_numpy(x), tk, tb, nf, g).numpy()
    assert rdb_mod.LAUNCHES == before  # the plain version is not a kernel launch
    np.testing.assert_allclose(y, y_pal, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(y, y_chain, atol=2e-5, rtol=1e-4)


def _dense_weights(rng, nf, g):
    kernels = [torch.from_numpy(rng.randn(g if i < 4 else nf, nf + i * g, 3, 3).astype(np.float32))
               for i in range(5)]
    biases = [torch.from_numpy(rng.randn(g if i < 4 else nf).astype(np.float32)) for i in range(5)]
    return kernels, biases


def test_pack_weights_layout(rng):
    nf, g = 64, 32
    kernels, biases = _dense_weights(rng, nf, g)
    packed = pack_weights(kernels, biases, nf, g, torch.bfloat16)
    assert [tuple(w.shape) for w in packed.weights] == [
        (4, 9, 2, 32, 8), (6, 9, 2, 32, 8), (8, 9, 2, 32, 8), (10, 9, 2, 32, 8), (12, 9, 2, 64, 8)]
    assert all(w.dtype == torch.bfloat16 and w.is_contiguous() for w in packed.weights)
    assert packed.bias.shape == (192,) and packed.bias.dtype == torch.float32
    np.testing.assert_array_equal(packed.bias.numpy(), torch.cat(biases).numpy())
    # bf16 element map the wgmma B descriptor relies on:
    # [j, kh*3 + kw, h, n, e] = W[n, 16j + 8h + e, kh, kw]
    w4 = packed.weights[4]
    for j, kh, kw, h, n, e in [(0, 0, 0, 0, 0, 0), (11, 2, 1, 1, 63, 7), (4, 1, 2, 0, 37, 5)]:
        assert w4[j, kh * 3 + kw, h, n, e] == kernels[4][n, 16 * j + 8 * h + e, kh, kw].bfloat16()
    # f32 element map of the direct kernel: [t, ci, kh*3 + kw, o] = W[t*32 + o, ci, kh, kw]
    f4 = pack_weights(kernels, biases, nf, g, torch.float32).weights[4]
    assert tuple(f4.shape) == (2, 192, 9, 32)
    for t, ci, kh, kw, o in [(0, 0, 0, 0, 0), (1, 191, 2, 1, 31), (1, 70, 1, 2, 5)]:
        assert f4[t, ci, kh * 3 + kw, o] == kernels[4][t * 32 + o, ci, kh, kw]
    assert [packed_shape(k, nf, g, torch.float32) for k in range(5)] == [
        (1, 64, 9, 32), (1, 96, 9, 32), (1, 128, 9, 32), (1, 160, 9, 32), (2, 192, 9, 32)]


@pytest.mark.parametrize("nf,g,dtype,match", [
    (16, 8, torch.float32, "divisible by 32"),
    (64, 96, torch.bfloat16, r"in \(32, 64\)"),
    (64, 32, torch.float16, "float32 or bfloat16"),
])
def test_pack_weights_rejects(rng, nf, g, dtype, match):
    kernels, biases = _dense_weights(rng, nf, g)
    with pytest.raises(ValueError, match=match):
        pack_weights(kernels, biases, nf, g, dtype)


# Geometry of csrc/rdb.cu's bf16 kernel, mirrored here: a block's band is
# 8 x 32 output pixels; its TMA box is (8 ch, 10 rows, 34 columns, 2 channel
# groups) from (0, y0 - 1, x0 - 1, 2j, b), written to shared memory innermost
# first; A's descriptor has LBO 5440 (channel-group plane) and SBO 160 (one
# column), B's LBO N*16 and SBO 128; tap (dy, dx) adds dy*16 + dx*160.
TH, TW, ROWS, COLS = 8, 32, 10, 34
A_LBO, A_SBO, B_SBO = ROWS * COLS * 16, ROWS * 16, 128


def _tma_box(buf, b, y, x, cg):
    """Emulates the tiled TMA load of the band's box from buf [B, H, W, C]
    viewed as (8, H, W, C/8, B), out-of-bounds elements as 0; returns the
    box's shared-memory image as a flat array of elements."""
    _, h, w, _ = buf.shape
    img = np.zeros((2, COLS, ROWS, 8), buf.dtype)  # innermost first: (8, rows, cols, groups)
    for gi in range(2):
        for ci in range(COLS):
            for ri in range(ROWS):
                yy, xx = y + ri, x + ci
                if 0 <= yy < h and 0 <= xx < w:
                    img[gi, ci, ri] = buf[b, yy, xx, 8 * (cg + gi): 8 * (cg + gi) + 8]
    return img.reshape(-1)


def _desc_gather(flat, start, rows, lbo, sbo):
    """The [rows, 16] K-major operand a no-swizzle wgmma descriptor reads:
    element (r, k) at byte start + (r//8)*sbo + (r%8)*16 + (k//8)*lbo + (k%8)*2."""
    r, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    byte = start + (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    return flat[byte // 2]


def _emulate_conv(buf, wpk, cin):
    """One launch of the bf16 kernel's index math in numpy: [B, H, W, N]."""
    bsz, h, w, _ = buf.shape
    n_out = wpk.shape[3]
    wflat = wpk.reshape(wpk.shape[0], -1)
    out = np.zeros((bsz, h, w, n_out), np.float32)
    for b in range(bsz):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                acc = np.zeros((4, 64, n_out), np.float32)
                for j in range(cin // 16):
                    band = _tma_box(buf, b, y0 - 1, x0 - 1, 2 * j)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        bmat = _desc_gather(wflat[j], tap * 2 * n_out * 16, n_out, n_out * 16, B_SBO)
                        for mt in range(4):
                            a = _desc_gather(band, (mt * 8 + dx) * A_SBO + dy * 16, 64, A_LBO, A_SBO)
                            acc[mt] += a @ bmat.T
                # M row m of tile mt is band row m % 8 of column 8 mt + m // 8
                for mt in range(4):
                    for m in range(64):
                        yy, xx = y0 + m % 8, x0 + 8 * mt + m // 8
                        if yy < h and xx < w:
                            out[b, yy, xx] = acc[mt, m]
    return out


@pytest.mark.parametrize("k,hw", [(1, 20), (4, 12)])
def test_bf16_packing_and_band_geometry_compute_the_conv(rng, k, hw):
    """The packed layout, TMA box and descriptor offsets of the bf16 kernel,
    run through numpy, give conv k of the RDB (zero padding included)."""
    nf, g = 64, 32
    kernels, biases = _dense_weights(rng, nf, g)
    cin = nf + k * g
    buf = rng.randn(2, hw, hw, nf + 4 * g).astype(np.float32)
    wpk = pack_weights(kernels, biases, nf, g, torch.bfloat16).weights[k].float().numpy()
    got = _emulate_conv(buf, wpk, cin)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(buf[..., :cin]).permute(0, 3, 1, 2),
        kernels[k].bfloat16().float(), padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


def test_tma_box_is_the_zero_padded_band(rng):
    buf = rng.randn(2, 12, 20, 48).astype(np.float32)
    pad = np.zeros((2, 12 + 20, 20 + 40, 48), np.float32)
    pad[:, 1:13, 1:21] = buf
    for b, y0, x0, cg in [(0, 0, 0, 0), (1, 8, 0, 4)]:
        got = _tma_box(buf, b, y0 - 1, x0 - 1, cg).reshape(2, COLS, ROWS, 8)
        want = pad[b, y0:y0 + ROWS, x0:x0 + COLS, 8 * cg: 8 * cg + 16]
        np.testing.assert_array_equal(got, want.reshape(ROWS, COLS, 2, 8).transpose(2, 1, 0, 3))


def test_rdb_rejects_unsupported_device():
    x = torch.zeros(1, 4, 4, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        rdb(x, [], [], 16, 8)

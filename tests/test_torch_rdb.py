"""The port's ResidualDenseBlock op against the JAX package's.

On the CPU the `rdb` wrapper runs its plain version; it is held against the
Pallas kernel in interpret mode and against the literal conv chain
(ResidualDenseBlock(fused=False)), at the tolerances of test_pallas_rdb.py:
the same f32 math, only the summation order differs. The CUDA kernels are held
against the plain version on the card by test_torch_cuda_kernels.py and
chip_smoke.py; here their packing, TMA boxes, descriptors and fragment maps
are emulated in numpy, and for float32 the three-TF32-product arithmetic.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs.rrdbnet import ResidualDenseBlock as JaxRDB
from satlas_sr_tpu.ops.pallas.rdb import rdb_pallas
from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
from satlas_sr_tpu_torch.ops.cuda.rdb import (pack_weights, packed_shape, rdb, rdb_reference,
                                              round_tf32)


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
    # f32 element map of the 3xTF32 kernel, hi rows then lo rows along N:
    # [j, kh*3 + kw, h, n, e] = hi or lo of W[n % 64, 8j + 4h + e, kh, kw]
    f32 = pack_weights(kernels, biases, nf, g, torch.float32).weights
    assert all(w.dtype == torch.float32 and w.is_contiguous() for w in f32)
    f4 = f32[4]
    assert tuple(f4.shape) == (24, 9, 2, 128, 4)
    for j, kh, kw, h, n, e in [(0, 0, 0, 0, 0, 0), (23, 2, 1, 1, 127, 3), (9, 1, 2, 0, 37, 2),
                               (9, 1, 2, 0, 101, 2)]:
        w = kernels[4][n % 64, 8 * j + 4 * h + e, kh, kw]
        hi = round_tf32(w)
        assert f4[j, kh * 3 + kw, h, n, e] == (hi if n < 64 else round_tf32(w - hi))
    # hi + lo gives back W to f32's rounding; lo is below hi's last bit
    rebuilt = (f4[:, :, :, :64] + f4[:, :, :, 64:]).permute(3, 0, 2, 4, 1).reshape(64, 192, 3, 3)
    np.testing.assert_allclose(rebuilt.numpy(), kernels[4].numpy(), rtol=2 ** -21, atol=0)
    assert (f4[:, :, :, 64:].abs() <= 2 ** -11 * f4[:, :, :, :64].abs()).all()
    assert [packed_shape(k, nf, g, torch.float32) for k in range(5)] == [
        (8, 9, 2, 64, 4), (12, 9, 2, 64, 4), (16, 9, 2, 64, 4), (20, 9, 2, 64, 4),
        (24, 9, 2, 128, 4)]


def test_round_tf32_is_round_to_nearest_ties_away(rng):
    x = np.concatenate([(rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096)).astype(np.float32),
                        np.float32([0.0, -0.0, 1.0, -1.0, 1 + 2 ** -11, -(1 + 2 ** -11),
                                    1 + 3 * 2 ** -11, 1 + 2 ** -11 - 2 ** -23])])
    got = round_tf32(torch.from_numpy(x)).numpy()
    assert (got.view(np.uint32) & 0x1FFF == 0).all()  # 10 mantissa bits left
    # nearest of the two TF32 neighbours, ties away from zero
    down = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    up = (down.view(np.uint32) + np.uint32(0x2000)).view(np.float32)
    d_down, d_up = np.abs(x.astype(np.float64) - down), np.abs(up.astype(np.float64) - x)
    np.testing.assert_array_equal(got, np.where(d_up <= d_down, up, down))
    assert got[-4] == 1 + 2 ** -10 and got[-3] == -(1 + 2 ** -10)  # ties go away from zero
    assert got[-2] == 1 + 2 ** -9 and got[-1] == 1.0


@pytest.mark.parametrize("nf,g,dtype,match", [
    (16, 8, torch.float32, r"in \(32, 64\)"),
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


def _tma_box(buf, b, y, x, cg, group=8):
    """Emulates the tiled TMA load of the band's box from buf [B, H, W, C]
    viewed as (group, H, W, C/group, B) (group = 16 bytes of channels: 8 in
    bf16, 4 in f32), out-of-bounds elements as 0; returns the box's
    shared-memory image as a flat array of elements."""
    _, h, w, _ = buf.shape
    img = np.zeros((2, COLS, ROWS, group), buf.dtype)  # innermost first
    for gi in range(2):
        for ci in range(COLS):
            for ri in range(ROWS):
                yy, xx = y + ri, x + ci
                if 0 <= yy < h and 0 <= xx < w:
                    img[gi, ci, ri] = buf[b, yy, xx, group * (cg + gi): group * (cg + gi) + group]
    return img.reshape(-1)


def _desc_gather(flat, start, rows, lbo, sbo, elt=2):
    """The [rows, 32 / elt] K-major operand a no-swizzle wgmma descriptor
    reads from elements of `elt` bytes (a core-matrix row is 16 bytes, kc =
    16 / elt elements): element (r, k) at byte start + (r//8)*sbo + (r%8)*16
    + (k//kc)*lbo + (k%kc)*elt."""
    kc = 16 // elt
    r, k = np.arange(rows)[:, None], np.arange(2 * kc)[None, :]
    byte = start + (r // 8) * sbo + (r % 8) * 16 + (k // kc) * lbo + (k % kc) * elt
    return flat[byte // elt]


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


# The f32 kernel's band holds 4 channels per 16-byte row: in floats a row is
# 4, a column 40, a channel plane 1360.
F_ROW, F_COL, F_PLANE = 4, ROWS * 4, ROWS * COLS * 4


def _a_fragment(band, mt, dy, dx):
    """The [64, 8] A operand of m64 tile mt, tap (dy, dx), gathered as the
    f32 kernel's consumer threads load it from the staged band (floats):
    thread (q, lane) of warpgroup mt // 2 starts at
    a0 = (16 wg + 2q)*40 + (lane//4)*4 + lane%4, adds (mt%2)*8*40 + dy*4 for
    the unit and reads column c, plane p at + p*1360 + c*40; its registers
    a0..a3 are (column dx, plane 0), (dx+1, 0), (dx, 1), (dx+1, 1), at M rows
    16q + lane//4 (+8 for a1, a3) and K columns lane%4 (+4 for a2, a3)."""
    wg, t = divmod(mt, 2)
    q, lane = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
    a0 = (16 * wg + 2 * q) * F_COL + (lane // 4) * F_ROW + lane % 4 + t * 8 * F_COL + dy * F_ROW
    m, k = 16 * q + lane // 4, lane % 4
    a = np.zeros((64, 8), band.dtype)
    for (c, p), (dm, dk) in zip([(dx, 0), (dx + 1, 0), (dx, 1), (dx + 1, 1)],
                                [(0, 0), (8, 0), (0, 4), (8, 4)]):
        a[m + dm, k + dk] = band[a0 + p * F_PLANE + c * F_COL]
    return a


def _split(v):
    """hi, lo of the f32 kernel's split (tf32_bits in csrc/rdb.cu), float64."""
    v = np.ascontiguousarray(v, np.float32)
    hi = round_tf32(torch.from_numpy(v)).numpy()
    return hi.astype(np.float64), round_tf32(torch.from_numpy(v - hi)).numpy().astype(np.float64)


def _emulate_conv_tf32x3(buf, wpk, cin):
    """One launch of the f32 kernel in numpy: its TMA box (4-channel rows),
    register fragments, B descriptors over the hi | lo packing, k8 stages
    and the three products hi*hi + lo*hi + hi*lo (sums in float64)."""
    bsz, h, w, _ = buf.shape
    n_out = wpk.shape[3] // 2
    wflat = wpk.reshape(wpk.shape[0], -1).astype(np.float64)
    out = np.zeros((bsz, h, w, n_out))
    for b in range(bsz):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                acc = np.zeros((4, 64, n_out))
                for j in range(cin // 8):
                    band = _tma_box(buf, b, y0 - 1, x0 - 1, 2 * j, group=4)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        start, lbo = tap * 2 * 2 * n_out * 16, 2 * n_out * 16
                        b_hi = _desc_gather(wflat[j], start, n_out, lbo, B_SBO, elt=4)
                        b_lo = _desc_gather(wflat[j], start + n_out * 16, n_out, lbo, B_SBO, elt=4)
                        for mt in range(4):
                            a_hi, a_lo = _split(_a_fragment(band, mt, dy, dx))
                            acc[mt] += a_hi @ b_hi.T + a_lo @ b_hi.T + a_hi @ b_lo.T
                for mt in range(4):
                    for m in range(64):
                        yy, xx = y0 + m % 8, x0 + 8 * mt + m // 8
                        if yy < h and xx < w:
                            out[b, yy, xx] = acc[mt, m]
    return out


@pytest.mark.parametrize("k,hw", [(1, 20), (4, 12)])
def test_f32_packing_and_band_geometry_compute_the_conv(rng, k, hw):
    """The f32 kernel's TMA box, register fragments, hi | lo packing, tap
    offsets and three TF32 products, run through numpy, give conv k of the
    RDB (zero padding included) to f32 accuracy."""
    nf, g = 64, 32
    kernels, biases = _dense_weights(rng, nf, g)
    cin = nf + k * g
    buf = rng.randn(2, hw, hw, nf + 4 * g).astype(np.float32)
    wpk = pack_weights(kernels, biases, nf, g, torch.float32).weights[k].numpy()
    got = _emulate_conv_tf32x3(buf, wpk, cin)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(buf[..., :cin]).double().permute(0, 3, 1, 2),
        kernels[k].double(), padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def _chip_smoke_rdb_inputs(batch):
    """x, weights and biases as chip_smoke.py's phase 2 draws them (seed 0,
    Kaiming fan-in scale), x cut to its first `batch` images."""
    gen = torch.Generator().manual_seed(0)
    nf, g = 64, 32
    x = torch.randn(64, 32, 32, nf, generator=gen)
    kernels, biases = [], []
    for k in range(5):
        cin, cout = nf + k * g, (g if k < 4 else nf)
        kernels.append(torch.randn(cout, cin, 3, 3, generator=gen) * np.sqrt(2 / (9 * cin)))
        biases.append(torch.randn(cout, generator=gen) * 0.01)
    return x[:batch].contiguous(), kernels, biases


def _rdb_tf32_products(x, kernels, biases, products):
    """The RDB with each conv's products taken as TF32 tensor cores take
    them: operands split into hi = tf32(v), lo = tf32(v - hi); products 3
    sums hi*hi + lo*hi + hi*lo, products 1 hi*hi only; sums in float64 and
    each conv's output rounded to f32, as the kernel stores it."""
    def conv(a, w):
        return torch.nn.functional.conv2d(a.double(), w.double(), padding=1)

    h = x.permute(0, 3, 1, 2)
    feats = [h]
    for k in range(5):
        a = torch.cat(feats, 1)
        a_hi, w_hi = round_tf32(a), round_tf32(kernels[k])
        y = conv(a_hi, w_hi)
        if products == 3:
            y = y + conv(round_tf32(a - a_hi), w_hi) + conv(a_hi, round_tf32(kernels[k] - w_hi))
        y = y + biases[k].double()[:, None, None]
        if k < 4:
            feats.append(torch.nn.functional.leaky_relu(y, 0.2).float())
    return (y * 0.2 + h.double()).float().permute(0, 2, 3, 1)


def test_three_tf32_products_hold_the_f32_tolerance_and_one_does_not():
    """chip_smoke.py holds the f32 kernel to atol 1e-4, rtol 1e-4 against
    the plain version; three TF32 products meet that on its weights, one
    product (plain TF32) fails it, so the card's check can tell them apart."""
    nf, g = 64, 32
    x, kernels, biases = _chip_smoke_rdb_inputs(2)
    want = rdb_reference(x.double(), [k.double() for k in kernels],
                         [b.double() for b in biases], nf, g).numpy()
    allowed = 1e-4 + 1e-4 * np.abs(want)
    three = _rdb_tf32_products(x, kernels, biases, 3).numpy()
    one = _rdb_tf32_products(x, kernels, biases, 1).numpy()
    assert (np.abs(three - want) / allowed).max() < 0.01
    assert (np.abs(one - want) / allowed).max() > 3


@pytest.mark.parametrize("group", [8, 4])  # channels per 16-byte row: bf16, f32
def test_tma_box_is_the_zero_padded_band(rng, group):
    buf = rng.randn(2, 12, 20, 48).astype(np.float32)
    pad = np.zeros((2, 12 + 20, 20 + 40, 48), np.float32)
    pad[:, 1:13, 1:21] = buf
    for b, y0, x0, cg in [(0, 0, 0, 0), (1, 8, 0, 4)]:
        got = _tma_box(buf, b, y0 - 1, x0 - 1, cg, group).reshape(2, COLS, ROWS, group)
        want = pad[b, y0:y0 + ROWS, x0:x0 + COLS, group * cg: group * cg + 2 * group]
        np.testing.assert_array_equal(
            got, want.reshape(ROWS, COLS, 2, group).transpose(2, 1, 0, 3))


def test_rdb_rejects_unsupported_device():
    x = torch.zeros(1, 4, 4, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        rdb(x, [], [], 16, 8)

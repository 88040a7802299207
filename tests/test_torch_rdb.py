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
from satlas_sr_tpu_torch.ops.cuda.rdb import (BAND_WIDTHS, MAX_CLUSTER, SMS, Route, pack_weights,
                                              packed_shape, rdb, rdb_reference, rdb_route,
                                              round_tf32)
from torch_threads import two_torch_threads  # noqa: F401


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
# 8 x TW output pixels (TW 32 by default; 16 or 8 in the f32 and cluster
# routes); its TMA box is (8 ch, 10 rows, TW + 2 columns, 2 channel groups)
# from (0, y0 - 1, x0 - 1, 2j, b), written to shared memory innermost first;
# A's descriptor has LBO (TW + 2) * 160 (channel-group plane: 5440 at TW 32)
# and SBO 160 (one column), B's LBO N*16 and SBO 128; tap (dy, dx) adds
# dy*16 + dx*160.
TH, TW, ROWS, COLS = 8, 32, 10, 34
A_LBO, A_SBO, B_SBO = ROWS * COLS * 16, ROWS * 16, 128


def _wg_split(tw, n_out):
    """The two consumer warpgroups' (first m64 tile, tiles, first output
    channel, channels) in csrc/rdb.cu's Band<TW>: TW/16 tiles each and all
    N, or at TW 8 (one tile) the same tile and half of N each."""
    tiles = tw // 8
    if tiles == 1:
        return [(0, 1, wg * n_out // 2, n_out // 2) for wg in range(2)]
    return [(wg * tiles // 2, tiles // 2, 0, n_out) for wg in range(2)]


def _tma_box(buf, b, y, x, cg, group=8, groups=2, cols=COLS):
    """Emulates the tiled TMA load of the band's box from buf [B, H, W, C]
    viewed as (group, H, W, C/group, B) (group = 16 bytes of channels: 8 in
    bf16, 4 in f32), out-of-bounds elements as 0; returns the box's
    shared-memory image as a flat array of elements."""
    _, h, w, _ = buf.shape
    img = np.zeros((groups, cols, ROWS, group), buf.dtype)  # innermost first
    for gi in range(groups):
        for ci in range(cols):
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


def _emulate_conv(buf, wpk, cin, tw=TW):
    """One launch of the bf16 kernel's index math in numpy, at band width
    tw, each warpgroup's tiles and channels as _wg_split gives them:
    [B, H, W, N]."""
    bsz, h, w, _ = buf.shape
    n_out = wpk.shape[3]
    wflat = wpk.reshape(wpk.shape[0], -1)
    cols = tw + 2
    lbo = ROWS * cols * 16
    out = np.zeros((bsz, h, w, n_out), np.float32)
    for b in range(bsz):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, tw):
                acc = np.zeros((tw // 8, 64, n_out), np.float32)
                for j in range(cin // 16):
                    band = _tma_box(buf, b, y0 - 1, x0 - 1, 2 * j, cols=cols)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        for tile0, tiles, n0, nw in _wg_split(tw, n_out):
                            bmat = _desc_gather(wflat[j], tap * 2 * n_out * 16 + n0 * 16, nw,
                                                n_out * 16, B_SBO)
                            for mt in range(tile0, tile0 + tiles):
                                a = _desc_gather(band, (mt * 8 + dx) * A_SBO + dy * 16, 64, lbo,
                                                 A_SBO)
                                acc[mt, :, n0:n0 + nw] += a @ bmat.T
                # M row m of tile mt is band row m % 8 of column 8 mt + m // 8
                for mt in range(tw // 8):
                    for m in range(64):
                        yy, xx = y0 + m % 8, x0 + 8 * mt + m // 8
                        if yy < h and xx < w:
                            out[b, yy, xx] = acc[mt, m]
    return out


def _conv_case(rng, k, shape, dtype):
    """conv k's packed weight (numpy, float32 view) and its plain output on
    a random concat buffer of `shape`: (buf, wpk, want), want in float64."""
    nf, g = 64, 32
    kernels, biases = _dense_weights(rng, nf, g)
    cin = nf + k * g
    buf = rng.randn(*shape, nf + 4 * g).astype(np.float32)
    wpk = pack_weights(kernels, biases, nf, g, dtype).weights[k].float().numpy()
    w = kernels[k].bfloat16().float() if dtype == torch.bfloat16 else kernels[k]
    want = torch.nn.functional.conv2d(
        torch.from_numpy(buf[..., :cin]).double().permute(0, 3, 1, 2), w.double(),
        padding=1).permute(0, 2, 3, 1).numpy()
    return buf, wpk, want


# every band width a route is built for, at the row counts of the small
# paths: whole 32x32 chips and the 13- and 18-row bands of a chip over 4 ranks
WIDTH_CASES = [(tw, h) for tw in (32, 16, 8) for h in (32, 13, 18)]
WIDTH_CONV = {32: 1, 13: 4, 18: 3}  # the conv each row count runs (N 32 or 64)


@pytest.mark.parametrize("tw,h", WIDTH_CASES)
def test_bf16_band_geometry_at_every_width(rng, tw, h):
    """The bf16 layout at band widths 32, 16 and 8 (the cluster route's
    resident buffers read with the same descriptors), with each
    warpgroup's tiles and channels, on ragged last bands: the conv."""
    k = WIDTH_CONV[h]
    buf, wpk, want = _conv_case(rng, k, (1, h, 32), torch.bfloat16)
    got = _emulate_conv(buf, wpk, 64 + 32 * k, tw=tw)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("tw,h", WIDTH_CASES)
def test_f32_band_geometry_at_every_width(rng, tw, h):
    """The f32 kernel at band widths 32, 16 and 8 (dense_conv3x3_tf32x3<N,
    TW>): fragments, split N at TW 8, three TF32 products: the conv to f32
    accuracy."""
    k = WIDTH_CONV[h]
    buf, wpk, want = _conv_case(rng, k, (1, h, 32), torch.float32)
    got = _emulate_conv_tf32x3(buf, wpk, 64 + 32 * k, tw=tw)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


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


def _a_fragment(band, mt, dy, dx, plane=F_PLANE):
    """The [64, 8] A operand of m64 tile mt, tap (dy, dx), gathered as the
    f32 kernel's consumer threads load it from the staged band (floats):
    thread (q, lane) of the warpgroup owning tile mt = tile0 + t starts at
    a0 = (8 tile0 + 2q)*40 + (lane//4)*4 + lane%4, adds t*8*40 + dy*4 for
    the unit and reads column c, plane p at + p*plane + c*40 (plane = 1360
    floats at TW 32, (TW + 2)*40 in general); its registers a0..a3 are
    (column dx, plane 0), (dx+1, 0), (dx, 1), (dx+1, 1), at M rows
    16q + lane//4 (+8 for a1, a3) and K columns lane%4 (+4 for a2, a3)."""
    q, lane = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
    a0 = (8 * mt + 2 * q) * F_COL + (lane // 4) * F_ROW + lane % 4 + dy * F_ROW
    m, k = 16 * q + lane // 4, lane % 4
    a = np.zeros((64, 8), band.dtype)
    for (c, p), (dm, dk) in zip([(dx, 0), (dx + 1, 0), (dx, 1), (dx + 1, 1)],
                                [(0, 0), (8, 0), (0, 4), (8, 4)]):
        a[m + dm, k + dk] = band[a0 + p * plane + c * F_COL]
    return a


def _split(v):
    """hi, lo of the f32 kernel's split (tf32_bits in csrc/rdb.cu), float64."""
    v = np.ascontiguousarray(v, np.float32)
    hi = round_tf32(torch.from_numpy(v)).numpy()
    return hi.astype(np.float64), round_tf32(torch.from_numpy(v - hi)).numpy().astype(np.float64)


def _emulate_conv_tf32x3(buf, wpk, cin, tw=TW):
    """One launch of the f32 kernel in numpy at band width tw: its TMA box
    (4-channel rows), register fragments, each warpgroup's tiles and
    channels (_wg_split), B descriptors over the hi | lo packing, k8 stages
    and the three products hi*hi + lo*hi + hi*lo (sums in float64)."""
    bsz, h, w, _ = buf.shape
    n_out = wpk.shape[3] // 2
    wflat = wpk.reshape(wpk.shape[0], -1).astype(np.float64)
    cols = tw + 2
    out = np.zeros((bsz, h, w, n_out))
    for b in range(bsz):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, tw):
                acc = np.zeros((tw // 8, 64, n_out))
                for j in range(cin // 8):
                    band = _tma_box(buf, b, y0 - 1, x0 - 1, 2 * j, group=4, cols=cols)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        for tile0, tiles, n0, nw in _wg_split(tw, n_out):
                            start, lbo = tap * 2 * 2 * n_out * 16 + n0 * 16, 2 * n_out * 16
                            b_hi = _desc_gather(wflat[j], start, nw, lbo, B_SBO, elt=4)
                            b_lo = _desc_gather(wflat[j], start + n_out * 16, nw, lbo, B_SBO,
                                                elt=4)
                            for mt in range(tile0, tile0 + tiles):
                                a_hi, a_lo = _split(_a_fragment(band, mt, dy, dx,
                                                                plane=ROWS * cols * 4))
                                acc[mt, :, n0:n0 + nw] += (a_hi @ b_hi.T + a_lo @ b_hi.T
                                                           + a_hi @ b_lo.T)
                for mt in range(tw // 8):
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


def _cluster_split(tw):
    """The cluster kernel's two consumer warpgroups as (m64 tile, k-step
    parity or None for every k-step): at TW 16 one tile each, every k-step;
    at TW 8 both on the one tile, alternate k-steps (their partial sums are
    added before the epilogue). Both take all N."""
    return [(0, 0), (0, 1)] if tw == 8 else [(0, None), (1, None)]


def _emulate_cluster(x, wpks, bias, tw, c):
    """The cluster route (csrc/rdb.cu rdb_cluster_wgmma) in numpy, one image
    a cluster: per block a resident concat [24 channel groups][tw + 2
    columns][10 rows][8 channels] (flat, float64), channels 0..63 filled by
    the TMA box of x (zero past the image's edge), 64..191 starting zero;
    each conv read through the bf16 descriptors from the block's own
    buffer, the warpgroups' tiles and k-steps as _cluster_split gives them;
    after each conv every block stores its valid pixels into its own
    buffer, then copies the new channel groups of its edge rows and columns
    (whole edges: a pixel past the image's edge is zero) into the halo slots
    of the neighbours that see them (the kernel's 16-byte DSMEM stores),
    and only then does the next conv start (the cluster barrier). Conv 5
    writes x + c*v. The layout and the exchange are what this checks:
    values stay float64 (the kernel rounds each conv's output to bf16; the
    card's tests hold that)."""
    nf, g, ct = 64, 32, 192
    bsz, h, w, _ = x.shape
    cols = tw + 2
    plane = cols * ROWS * 8  # elements of one channel group
    lbo = plane * 2  # bytes
    nby, nbx = -(-h // TH), -(-w // tw)
    n = nby * nbx
    assert n <= MAX_CLUSTER

    def at(ch, ri, ci):
        return (ch // 8) * plane + ci * ROWS * 8 + ri * 8 + ch % 8

    out = np.zeros(x.shape)
    for b in range(bsz):
        res = []
        for rank in range(n):
            by, bx = divmod(rank, nbx)
            r = np.zeros(ct // 8 * plane)
            r[:8 * plane] = _tma_box(x, b, by * TH - 1, bx * tw - 1, 0, groups=8, cols=cols)
            res.append(r)
        for k in range(5):
            n_out, cin = (g if k < 4 else nf), nf + k * g
            wflat = wpks[k].reshape(cin // 16, -1)
            for rank in range(n):
                by, bx = divmod(rank, nbx)
                acc = np.zeros((tw // 8, 64, n_out))
                for tile, parity in _cluster_split(tw):
                    for j in range(cin // 16):
                        if parity is not None and j % 2 != parity:
                            continue
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            bmat = _desc_gather(wflat[j], tap * 2 * n_out * 16, n_out,
                                                n_out * 16, B_SBO)
                            a = _desc_gather(res[rank], 2 * j * lbo + (tile * 8 + dx) * A_SBO
                                             + dy * 16, 64, lbo, A_SBO)
                            acc[tile] += a @ bmat.T
                for tile in range(tw // 8):
                    for m in range(64):
                        row, col = m % 8, tile * 8 + m // 8
                        gy, gx = by * TH + row, bx * tw + col
                        if gy >= h or gx >= w:
                            continue
                        v = acc[tile, m] + bias[k * g: k * g + n_out]
                        if k == 4:
                            xv = res[rank][[at(ch, row + 1, col + 1) for ch in range(nf)]]
                            out[b, gy, gx] = xv + c * v
                        else:
                            chans = range(nf + k * g, nf + (k + 1) * g)
                            res[rank][[at(ch, row + 1, col + 1) for ch in chans]] = \
                                np.where(v >= 0, v, c * v)
            if k == 4:
                break
            for rank in range(n):  # after every block's epilogue: the halos
                by, bx = divmod(rank, nbx)
                chans = range(nf + k * g, nf + (k + 1) * g)
                for dyn in (-1, 0, 1):
                    for dxn in (-1, 0, 1):
                        if (dyn, dxn) == (0, 0) \
                                or not (0 <= by + dyn < nby and 0 <= bx + dxn < nbx):
                            continue
                        peer = res[(by + dyn) * nbx + bx + dxn]
                        rows = [1] if dyn < 0 else [TH] if dyn > 0 else range(1, TH + 1)
                        cls = [1] if dxn < 0 else [tw] if dxn > 0 else range(1, tw + 1)
                        for ri in rows:
                            for ci in cls:
                                src = [at(ch, ri, ci) for ch in chans]
                                peer[[at(ch, ri - dyn * TH, ci - dxn * tw) for ch in chans]] = \
                                    res[rank][src]
    return out


@pytest.mark.parametrize("tw,h", [(tw, h) for tw in (8, 16) for h in (32, 13, 18)])
def test_cluster_route_emulation_computes_the_rdb(rng, tw, h):
    """Five convs through per-block resident buffers, halos filled from the
    neighbours after each conv, a zero border and ragged last bands: the
    RDB of `rdb_reference` on the bf16-rounded weights, and through it the
    JAX package's conv chain (ResidualDenseBlock(fused=False)) and, on
    32 x 32 images, rdb_pallas in interpret mode, at this file's f32
    tolerances (atol 2e-5, rtol 1e-4)."""
    nf, g, bsz = 64, 32, 2
    kernels, biases = _dense_weights(rng, nf, g)
    kernels = [(k * np.sqrt(2 / (9 * k.shape[1]))).bfloat16().float() for k in kernels]
    biases = [b * 0.1 for b in biases]
    x = rng.randn(bsz, h, 32, nf).astype(np.float32)
    packed = pack_weights(kernels, biases, nf, g, torch.bfloat16)
    wpks = [wk.double().numpy() for wk in packed.weights]
    got = _emulate_cluster(x.astype(np.float64), wpks, packed.bias.double().numpy(), tw, 0.2)
    want = rdb_reference(torch.from_numpy(x), kernels, biases, nf, g).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    hwio = [np.ascontiguousarray(k.numpy().transpose(2, 3, 1, 0)) for k in kernels]
    m = JaxRDB(nf, g, fused=False)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    for i in range(5):
        v["params"][f"conv{i + 1}"] = {"kernel": jnp.asarray(hwio[i]),
                                       "bias": jnp.asarray(biases[i].numpy())}
    np.testing.assert_allclose(got, np.asarray(m.apply(v, jnp.asarray(x))), atol=2e-5, rtol=1e-4)
    if h == 32:
        y_pal = rdb_pallas(jnp.asarray(x), [jnp.asarray(k) for k in hwio],
                           [jnp.asarray(b.numpy()) for b in biases], nf, g, tile=bsz,
                           interpret=True)
        np.testing.assert_allclose(got, np.asarray(y_pal), atol=2e-5, rtol=1e-4)


# Every shape of PERF.md's kernel table, in each dtype it runs in there.
TABLE_SHAPES = {
    torch.bfloat16: [(64, 32, 32), (8, 32, 32), (256, 32, 32), (1, 512, 512), (1, 32, 32),
                     (4, 32, 32), (32, 32, 32), (16, 32, 32), (1, 138, 512), (1, 133, 512),
                     (32, 13, 32), (32, 18, 32), (1, 13, 32), (1, 18, 32)],
    torch.float32: [(64, 32, 32), (8, 32, 32), (1, 512, 512), (1, 32, 32), (4, 32, 32),
                    (2, 32, 32), (32, 32, 32), (16, 32, 32), (1, 138, 512), (1, 133, 512),
                    (8, 21, 32)],
}


@pytest.mark.parametrize("dtype,shape", [(d, s) for d, ss in TABLE_SHAPES.items() for s in ss],
                         ids=lambda v: str(v).replace("torch.", "").replace(", ", "x"))
def test_rdb_route_maps_every_table_shape_to_a_kernel_that_takes_it(dtype, shape):
    b, h, w = shape
    route = rdb_route(b, h, w, dtype)
    assert isinstance(route, Route)
    assert route.tw in BAND_WIDTHS[route.kernel][dtype]
    if route.kernel == "cluster":  # one cluster an image, at most 16 bands, nf 64 / g 32
        assert -(-h // 8) * -(-w // route.tw) <= MAX_CLUSTER
        assert b * -(-h // 8) * -(-w // route.tw) <= SMS // 2
        assert rdb_route(b, h, w, dtype, nf=32, g=32).kernel == "bands"
    if w == 512 or b >= 64:  # today's kernels keep the wide tiles, the bands and batch 64
        assert route == Route("bands", 32)


@pytest.mark.parametrize("dtype,b,want", [
    (torch.bfloat16, 1, Route("cluster", 8)), (torch.bfloat16, 4, Route("cluster", 8)),
    (torch.bfloat16, 8, Route("cluster", 16)), (torch.bfloat16, 16, Route("bands", 32)),
    (torch.bfloat16, 32, Route("bands", 32)), (torch.float32, 1, Route("bands", 8)),
    (torch.float32, 8, Route("bands", 8)), (torch.float32, 16, Route("bands", 16)),
    (torch.float32, 32, Route("bands", 32)),
])
def test_rdb_route_at_the_small_batches(dtype, b, want):
    """The routes chip_smoke.py measured fastest at x [b, 32, 32, 64] on an
    H100 (PERF.md's kernel table): the cluster while the batch's clusters
    fill at most half the card, the f32 bands as narrow as one wave allows."""
    assert rdb_route(b, 32, 32, dtype) == want


def test_launch_rejects_a_route_the_kernels_do_not_have(rng):
    kernels, biases = _dense_weights(rng, 64, 32)
    packed = pack_weights(kernels, biases, 64, 32, torch.float32)
    x = torch.zeros(1, 8, 8, 64)
    with pytest.raises(ValueError, match="no cluster route"):
        rdb_mod._launch(x, packed, 64, 32, route=Route("cluster", 8))
    with pytest.raises(ValueError, match="band width 12"):
        rdb_mod._launch(x, packed, 64, 32, route=Route("bands", 12))

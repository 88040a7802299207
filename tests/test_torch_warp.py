"""The port's warp ops (ops/warp.py) and the blocks no registered arch uses
(archs/blocks.py: DCNv2Pack, ResidualBlockNoBN, Upsample, ConvTransposeBlock,
DenseBlock, trunc_normal_init) against the JAX package.

The same numpy inputs go through satlas_sr_tpu/ops/warp.py and the port,
float32 on the CPU. Values and the gradients of <out, cotangent> with
respect to every input are held within atol 1e-5 (rtol 1e-5); the blocks run
on the JAX module's parameters carried across by the converters of
utils/torch_io.py, within atol 1e-5 (rtol 1e-4, as the JAX block tests).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs import blocks as jax_blocks
from satlas_sr_tpu.ops import warp as jax_warp
from satlas_sr_tpu_torch.archs import blocks
from satlas_sr_tpu_torch.ops import warp
from satlas_sr_tpu_torch.utils import torch_io
from torch_threads import two_torch_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))).requires_grad_()


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _grads(fn_jax, fn_torch, args_nhwc, layouts, cot):
    """Values and input gradients of sum(out * cot) on both sides; layouts
    say which arguments are images (NHWC in JAX, NCHW in the port)."""
    out_j, vjp = jax.vjp(fn_jax, *[jnp.asarray(a) for a in args_nhwc])
    g_j = vjp(jnp.asarray(cot))
    ts = [_nchw(a) if img else torch.from_numpy(a.copy()).requires_grad_()
          for a, img in zip(args_nhwc, layouts)]
    out_t = fn_torch(*ts)
    (out_t * torch.from_numpy(np.ascontiguousarray(np.transpose(cot, (0, 3, 1, 2))))).sum().backward()
    g_t = [_nhwc(t.grad) if img else t.grad.numpy() for t, img in zip(ts, layouts)]
    return np.asarray(out_j), _nhwc(out_t), [np.asarray(g) for g in g_j], g_t


def _flow(rng, kind, n=2, h=8, w=8):
    if kind == "zero":
        return np.zeros((n, h, w, 2), np.float32)
    if kind == "shift":
        f = np.zeros((n, h, w, 2), np.float32)
        f[..., 0], f[..., 1] = 1.0, -2.0
        return f
    return ((rng.rand(n, h, w, 2) - 0.5) * 5).astype(np.float32)


@pytest.mark.parametrize("kind", ["zero", "shift", "random"])
def test_flow_warp_matches_jax(rng, kind):
    x = rng.rand(2, 8, 8, 3).astype(np.float32)
    flow = _flow(rng, kind)
    cot = rng.randn(2, 8, 8, 3).astype(np.float32)
    yj, yt, gj, gt = _grads(jax_warp.flow_warp, warp.flow_warp, [x, flow], [True, False], cot)
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_allclose(gt[0], gj[0], **TOL)
    if kind == "random":  # at integer sample points the flow gradient is a one-sided choice
        np.testing.assert_allclose(gt[1], gj[1], **TOL)
    if kind == "zero":
        np.testing.assert_allclose(yt, x, atol=1e-6)
    if kind == "shift":  # dx = +1, dy = -2: rows from two above, columns from one right
        np.testing.assert_allclose(yt[:, 2:, :-1], x[:, :-2, 1:], atol=1e-6)
        assert np.abs(yt[:, :2]).max() == 0 and np.abs(yt[:, :, -1]).max() == 0


def test_flow_warp_nearest_and_unaligned_match_jax(rng):
    x = rng.rand(1, 8, 8, 3).astype(np.float32)
    flow = _flow(rng, "random", n=1)
    for kw in ({"interp_mode": "nearest"}, {"align_corners": False}):
        want = np.asarray(jax_warp.flow_warp(jnp.asarray(x), jnp.asarray(flow), **kw))
        got = _nhwc(warp.flow_warp(_nchw(x), torch.from_numpy(flow), **kw))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size_type,sizes", [("ratio", (2.0, 2.0)), ("shape", (12, 20)),
                                             ("ratio", (0.5, 0.5))])
def test_resize_flow_matches_jax(rng, size_type, sizes):
    flow = _flow(rng, "random")
    want = np.asarray(jax_warp.resize_flow(jnp.asarray(flow), size_type, sizes))
    got = warp.resize_flow(torch.from_numpy(flow), size_type, sizes).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _deform_inputs(rng, kind, cin=4, cout=6, h=8, w=8):
    x = rng.rand(2, h, w, cin).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) * 0.3).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    offsets = np.zeros((2, h, w, 18), np.float32)
    mask = np.ones((2, h, w, 9), np.float32)
    if kind == "integer":
        offsets[..., 0::2] = 1.0  # dy = +1 on every tap
        offsets[..., 1::2] = -1.0  # dx = -1
    elif kind == "random":
        offsets = ((rng.rand(2, h, w, 18) - 0.5) * 4).astype(np.float32)
        mask = rng.rand(2, h, w, 9).astype(np.float32)
    return x, offsets, weight, bias, mask


@pytest.mark.parametrize("kind", ["zero", "integer", "random"])
def test_deform_conv2d_matches_jax(rng, kind):
    x, offsets, weight, bias, mask = _deform_inputs(rng, kind)
    cot = rng.randn(2, 8, 8, 6).astype(np.float32)

    def fj(x_, o_, w_, b_, m_):
        return jax_warp.deform_conv2d(x_, o_, w_, b_, m_)

    def ft(x_, o_, w_, b_, m_):
        return warp.deform_conv2d(x_, o_, w_.permute(3, 2, 0, 1), b_, m_)

    yj, yt, gj, gt = _grads(fj, ft, [x, offsets, weight, bias, mask],
                            [True, True, False, False, True], cot)
    np.testing.assert_allclose(yt, yj, **TOL)
    for name, a, b in zip(("x", "offsets", "weight", "bias", "mask"), gt, gj):
        if name == "offsets" and kind != "random":
            continue  # integer sample points: the floor's one-sided gradient
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    if kind == "zero":  # zero offsets, unit mask: a plain conv
        ref = torch.nn.functional.conv2d(_nchw(x), torch.from_numpy(weight).permute(3, 2, 0, 1),
                                         torch.from_numpy(bias), padding=1)
        np.testing.assert_allclose(yt, _nhwc(ref), atol=1e-5, rtol=1e-5)


def _jitter(variables, seed, scale=None):
    """numpy copies of the variables, with non-zero biases, offsets and PReLU
    slopes, so that each one is wired (conv_offset's kernel times `scale`,
    for offsets of a few pixels)."""
    rng = np.random.RandomState(seed)

    def f(path, leaf):
        leaf = np.asarray(leaf) + 0.1 * rng.randn(*leaf.shape).astype(np.float32)
        return leaf * scale if scale and "conv_offset" in jax.tree_util.keystr(path) else leaf

    return jax.tree_util.tree_map_with_path(f, variables)


def _materialise(module, state):
    module.to_empty(device="cpu")
    module.load_state_dict(state)
    return module.eval()


BLOCKS = {
    "ResidualBlockNoBN": (lambda: jax_blocks.ResidualBlockNoBN(num_feat=4, res_scale=0.5),
                          lambda: blocks.ResidualBlockNoBN(4, res_scale=0.5),
                          torch_io.residual_block_nobn_from_jax, (4, 8)),
    "Upsample2": (lambda: jax_blocks.Upsample(scale=2, num_feat=4), lambda: blocks.Upsample(2, 4),
                  torch_io.upsample_from_jax, (4, 8)),
    "Upsample3": (lambda: jax_blocks.Upsample(scale=3, num_feat=4), lambda: blocks.Upsample(3, 4),
                  torch_io.upsample_from_jax, (4, 8)),
    "Upsample4": (lambda: jax_blocks.Upsample(scale=4, num_feat=4), lambda: blocks.Upsample(4, 4),
                  torch_io.upsample_from_jax, (4, 8)),
    "ConvTransposeBlock": (lambda: jax_blocks.ConvTransposeBlock(4, 3, zoom_factor=2),
                           lambda: blocks.ConvTransposeBlock(4, 3, zoom_factor=2),
                           torch_io.conv_transpose_block_from_jax, (4, 8)),
    "DenseBlock": (lambda: jax_blocks.DenseBlock(4), lambda: blocks.DenseBlock(4),
                   torch_io.dense_block_from_jax, (4, 8)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(rng, name):
    make_jax, make_port, convert, (c, hw) = BLOCKS[name]
    x = rng.rand(2, hw, hw, c).astype(np.float32)
    m = make_jax()
    variables = _jitter(m.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    want = np.asarray(m.apply(variables, jnp.asarray(x)))
    port = _materialise(make_port(), convert(variables))
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_dcnv2pack_matches_jax_values_and_gradients(rng):
    x = rng.rand(2, 8, 8, 4).astype(np.float32)
    feat = rng.rand(2, 8, 8, 4).astype(np.float32)
    m = jax_blocks.DCNv2Pack(features=6)
    variables = _jitter(m.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(feat)), 3,
                        scale=10)
    port = _materialise(blocks.DCNv2Pack(4, 6), torch_io.dcnv2_pack_from_jax(variables))
    cot = rng.randn(2, 8, 8, 6).astype(np.float32)
    yj, vjp = jax.vjp(lambda v, a, b: m.apply(v, a, b), variables, jnp.asarray(x),
                      jnp.asarray(feat))
    g_v, g_x, g_feat = vjp(jnp.asarray(cot))
    xt, ft = _nchw(x), _nchw(feat)
    yt = port(xt, ft)
    (yt * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    assert np.abs(np.asarray(yj) - _nhwc(_plain_conv(port, x))).max() > 1e-2  # offsets move taps
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(g_x), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_nhwc(ft.grad), np.asarray(g_feat), atol=1e-5, rtol=1e-4)
    want = torch_io.dcnv2_pack_from_jax(jax.tree_util.tree_map(np.asarray, g_v))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def _plain_conv(port, x):
    with torch.no_grad():
        return torch.nn.functional.conv2d(_nchw(x), port.weight, port.bias, padding=1)


def test_fresh_dcnv2pack_is_a_half_masked_conv(rng):
    """conv_offset starts at zero: no offsets, mask sigmoid(0) = 0.5."""
    port = blocks.DCNv2Pack(4, 6)
    port.to_empty(device="cpu")
    blocks.init_weights(port, torch.Generator().manual_seed(0))
    assert not port.conv_offset.weight.any() and not port.bias.any()
    x = rng.rand(1, 8, 8, 4).astype(np.float32)
    with torch.no_grad():
        got = port(_nchw(x), _nchw(x))
        want = torch.nn.functional.conv2d(_nchw(x), 0.5 * port.weight, padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_trunc_normal_init_is_seeded_and_matches_jax_statistics():
    init = blocks.trunc_normal_init(std=0.5, mean=0.1, a=-0.5, b=0.6)
    a = init((20000,), torch.Generator().manual_seed(0))
    b = init((20000,), torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert a.min() >= -0.5 and a.max() <= 0.6
    ref = np.asarray(jax_blocks.trunc_normal_init(std=0.5, mean=0.1, a=-0.5, b=0.6)(
        jax.random.PRNGKey(0), (20000,)))
    # same distribution: moments within 4 standard errors of JAX's draw
    se = ref.std() / np.sqrt(ref.size)
    assert abs(a.mean().item() - ref.mean()) < 4 * np.sqrt(2) * se
    assert abs(a.std().item() - ref.std()) < 0.02

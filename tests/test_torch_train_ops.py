"""The train step's ops in the port against the JAX package's, on the CPU in float32.

- `rdb_backward` (the RDB's backward from its saved concat buffer) and the
  autograd Function the trainer runs, against `jax.grad` of the JAX
  ResidualDenseBlock(fused=False): dx, dW_k and db_k within
  1e-4 * max|ref| + 1e-6.
- `usm_sharp`: the thresholded mask may flip where a float difference
  straddles 10/255; at most 1 flip per 10,000 mask values is allowed, and
  the output is within 1e-5 where none flipped (2e-3, a flip's reach
  through the soft mask, otherwise).
- `SNConv`: output, the power-iterated u and v, and the kernel's gradient,
  within 1e-5 (relative to the reference's max for the gradient).
- The U-Net SN discriminator with the JAX variables carried over by
  `unet_disc_from_jax`: logits and u/v after a forward with update_stats;
  its bilinear x2 upsampling (shifted sums) against F.interpolate.
- The kernel's packed weights follow an optimizer step: fused Adam updates
  in place without bumping `_version`, so the trainer invalidates the packs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs.discriminator import UNetDiscriminatorSN as JaxDisc
from satlas_sr_tpu.archs.rrdbnet import ResidualDenseBlock as JaxRDB
from satlas_sr_tpu.ops import usm as jax_usm
from satlas_sr_tpu.ops.spectral_norm import SNConv as JaxSNConv
from satlas_sr_tpu_torch.archs import ResidualDenseBlock, UNetDiscriminatorSN
from satlas_sr_tpu_torch.ops import usm
from satlas_sr_tpu_torch.ops.cuda.rdb import (pack_weights, rdb, rdb_backward,
                                              rdb_reference_with_concat)
from satlas_sr_tpu_torch.ops.spectral_norm import SNConv
from satlas_sr_tpu_torch.utils.torch_io import unet_disc_from_jax
from torch_threads import two_torch_threads  # noqa: F401


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))


def _close(got, want, rel=1e-4, atol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + atol, (err, np.abs(want).max())


def _jax_rdb_grads(rng, nf, g, batch=2, hw=8):
    x = rng.randn(batch, hw, hw, nf).astype(np.float32)
    gy = rng.randn(batch, hw, hw, nf).astype(np.float32)
    m = JaxRDB(nf, g, fused=False)
    params = {f"conv{k + 1}": {  # the JAX layout, drawn with numpy (no flax init)
        "kernel": (rng.randn(3, 3, nf + k * g, g if k < 4 else nf)
                   * np.sqrt(2.0 / (9 * (nf + k * g)))).astype(np.float32),
        "bias": (0.05 * rng.randn(g if k < 4 else nf)).astype(np.float32)} for k in range(5)}
    loss = jax.jit(lambda p, xx: jnp.sum(m.apply({"params": p}, xx) * gy))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    p = jax.tree.map(np.asarray, params)
    kernels = [_oihw(p[f"conv{k + 1}"]["kernel"]) for k in range(5)]
    biases = [torch.from_numpy(np.array(p[f"conv{k + 1}"]["bias"])) for k in range(5)]
    gp = jax.tree.map(np.asarray, gp)
    want = ([np.asarray(gx)], [np.transpose(gp[f"conv{k + 1}"]["kernel"], (3, 2, 0, 1)) for k in range(5)],
            [gp[f"conv{k + 1}"]["bias"] for k in range(5)])
    return torch.from_numpy(x), torch.from_numpy(gy), kernels, biases, want


@pytest.mark.parametrize("nf,g", [(8, 4), (16, 8)])
def test_rdb_backward_matches_jax_grad(rng, nf, g):
    x, gy, kernels, biases, (want_x, want_w, want_b) = _jax_rdb_grads(rng, nf, g)
    _, buf = rdb_reference_with_concat(x, kernels, biases, nf, g)
    assert buf.shape == (*x.shape[:3], nf + 4 * g)
    np.testing.assert_array_equal(buf[..., :nf].numpy(), x.numpy())
    dx, dws, dbs = rdb_backward(buf, gy, kernels, nf, g)
    _close(dx, want_x[0])
    for k in range(5):
        _close(dws[k], want_w[k])
        _close(dbs[k], want_b[k])


def test_rdb_autograd_function_matches_jax_grad(rng):
    """The path the trainer takes: `rdb` under autograd on a CPU tensor runs
    the Function (plain forward filling the concat, `rdb_backward`)."""
    nf, g = 8, 4
    x, gy, kernels, biases, (want_x, want_w, want_b) = _jax_rdb_grads(rng, nf, g)
    x.requires_grad_()
    params = [t.clone().requires_grad_() for kb in zip(kernels, biases) for t in kb]
    y = rdb(x, params[0::2], params[1::2], nf, g)
    assert y.grad_fn is not None and "RDBFunction" in type(y.grad_fn).__name__
    grads = torch.autograd.grad(y, [x, *params], gy)
    _close(grads[0], want_x[0])
    for k in range(5):
        _close(grads[1 + 2 * k], want_w[k])
        _close(grads[2 + 2 * k], want_b[k])


def test_rdb_under_no_grad_is_the_plain_version(rng):
    nf, g = 8, 4
    x, _, kernels, biases, _ = _jax_rdb_grads(rng, nf, g)
    params = [t.requires_grad_() for t in kernels + biases]
    with torch.no_grad():
        y = rdb(x, params[:5], params[5:], nf, g)
    assert y.grad_fn is None


@pytest.mark.parametrize("shape", [(2, 128, 128, 3), (1, 40, 24, 3)])
def test_usm_sharp_matches_jax(rng, shape):
    img = rng.rand(*shape).astype(np.float32)
    img[:, : shape[1] // 2] = 0.5 + 0.02 * img[:, : shape[1] // 2]  # a smooth half
    got = usm.usm_sharp(torch.from_numpy(img)).numpy()
    want = np.asarray(jax_usm.usm_sharp(jnp.asarray(img)))
    ksize = 51
    mask_p = (np.abs(img - usm._blur_separable(torch.from_numpy(img), ksize).numpy()) * 255 > 10)
    mask_j = (np.abs(img - np.asarray(jax_usm._blur_separable(jnp.asarray(img), ksize))) * 255 > 10)
    flips = int((mask_p != mask_j).sum())
    assert flips <= mask_p.size // 10_000, flips
    assert 0 < mask_p.mean() < 1  # the threshold does cut this image
    np.testing.assert_allclose(got, want, atol=1e-5 if flips == 0 else 2e-3, rtol=0)
    np.testing.assert_array_equal(usm._blur_matrix(ksize, 40), jax_usm._blur_matrix(ksize, 40))


@pytest.mark.parametrize("update_stats", [True, False])
def test_snconv_matches_jax(rng, update_stats):
    cin, cout = 6, 8
    x = rng.randn(2, 16, 16, cin).astype(np.float32)
    gy = rng.randn(2, 8, 8, cout).astype(np.float32)
    m = JaxSNConv(cout, (4, 4), (2, 2), 1, use_bias=False)
    v = m.init(jax.random.PRNGKey(2), jnp.asarray(x))
    v = {"params": v["params"], "spectral": jax.tree.map(np.asarray, v["spectral"])}

    def loss(params):
        y, mut = m.apply({"params": params, "spectral": v["spectral"]}, jnp.asarray(x),
                         update_stats=update_stats, mutable=["spectral"])
        return jnp.sum(y * gy), (y, mut["spectral"])

    (_, (y, spec)), gk = jax.value_and_grad(loss, has_aux=True)(v["params"])
    port = SNConv(cin, cout, 4, 2, 1, bias=False)
    port.load_state_dict({"weight_orig": _oihw(v["params"]["kernel"]),
                          "weight_u": torch.from_numpy(v["spectral"]["u"]),
                          "weight_v": torch.from_numpy(v["spectral"]["v"])})
    out = port(torch.from_numpy(x), update_stats=update_stats)
    (out * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.weight_u.numpy(), np.asarray(spec["u"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.weight_v.numpy(), np.asarray(spec["v"]), atol=1e-6, rtol=0)
    _close(port.weight_orig.grad, np.transpose(np.asarray(gk["kernel"]), (3, 2, 0, 1)), rel=1e-5)


def _disc_variables(rng, cin, nf):
    """U-Net SN variables in the JAX layout, drawn with numpy (no flax init)."""
    shapes = {"conv0": (3, cin, nf), "conv1": (4, nf, nf * 2), "conv2": (4, nf * 2, nf * 4),
              "conv3": (4, nf * 4, nf * 8), "conv4": (3, nf * 8, nf * 4),
              "conv5": (3, nf * 4, nf * 2), "conv6": (3, nf * 2, nf), "conv7": (3, nf, nf),
              "conv8": (3, nf, nf), "conv9": (3, nf, 1)}
    params, spectral = {}, {}
    unit = lambda n: (lambda a: a / np.linalg.norm(a))(rng.randn(n)).astype(np.float32)
    for name, (k, i, o) in shapes.items():
        params[name] = {"kernel": (rng.randn(k, k, i, o) / np.sqrt(k * k * i)).astype(np.float32)}
        if name in ("conv0", "conv9"):
            params[name]["bias"] = (0.1 * rng.randn(o)).astype(np.float32)
        else:
            spectral[name] = {"u": unit(o), "v": unit(k * k * i)}
    return {"params": params, "spectral": spectral}


def test_discriminator_with_carried_weights_matches_jax(rng):
    cin, nf = 9, 4
    v = _disc_variables(rng, cin, nf)
    x = rng.rand(2, 32, 32, cin).astype(np.float32)
    jd = JaxDisc(num_in_ch=cin, num_feat=nf)
    fwd = jax.jit(lambda vv, xx: jd.apply(vv, xx, update_stats=True, mutable=["spectral"]))
    want, mut = fwd(v, jnp.asarray(x))
    port = UNetDiscriminatorSN(cin, nf, device="cpu")
    port.load_state_dict(unet_disc_from_jax(v))
    with torch.no_grad():
        got = port(torch.from_numpy(x), update_stats=True)
    assert got.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    state = port.state_dict()
    for name, uv in jax.device_get(mut["spectral"]).items():
        np.testing.assert_allclose(state[f"{name}.weight_u"].numpy(), uv["u"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(state[f"{name}.weight_v"].numpy(), uv["v"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2), (2, 16, 16, 8)])
def test_discriminator_upsample_matches_interpolate(shape):
    """The U-Net D's bilinear x2 as shifted sums (no atomics in its backward)
    against F.interpolate: output and input gradient within 1e-6 of the
    reference's scale (max(1, max|ref|))."""
    import torch.nn.functional as F

    from satlas_sr_tpu_torch.archs.discriminator import up2_bilinear

    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(*shape, generator=gen, requires_grad=True)
    g = torch.randn(shape[0], 2 * shape[1], 2 * shape[2], shape[3], generator=gen)
    got = up2_bilinear(x)
    want = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    for a, b in ((got, want), torch.autograd.grad(got, x, g) + torch.autograd.grad(want, x, g)):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-6 * max(1.0, b.abs().max().item())


def test_kernel_pack_follows_an_optimizer_step():
    """A fused Adam step changes the weights in place without bumping their
    `_version`, so a cached pack would go stale; `invalidate_pack` (which the
    trainer calls after each step) repacks from the new weights."""
    block = ResidualDenseBlock(32, 32)
    block.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(0)
    for c in block.convs():
        torch.nn.init.normal_(c.weight, 0, 0.02, generator=gen)
        torch.nn.init.normal_(c.bias, 0, 0.02, generator=gen)
    x = torch.zeros(1, 8, 8, 32)
    old = [w.clone() for w in block._packed_for(x).weights]
    opt = torch.optim.Adam(block.parameters(), lr=1e-2, fused=True)
    for p in block.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    stale = block._packed_for(x).weights
    assert all(torch.equal(a, b) for a, b in zip(old, stale))  # fused Adam: no version bump
    block.invalidate_pack()
    convs = block.convs()
    fresh = pack_weights([c.weight for c in convs], [c.bias for c in convs], 32, 32, torch.float32)
    got = block._packed_for(x)
    assert all(torch.equal(a, b) for a, b in zip(got.weights, fresh.weights))
    assert torch.equal(got.bias, fresh.bias)
    assert not all(torch.equal(a, b) for a, b in zip(old, got.weights))

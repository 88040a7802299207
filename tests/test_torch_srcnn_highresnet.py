"""The port's SRCNN and HighResNet (and their blocks) against the JAX package.

Small widths (hidden 16, one residual layer), float32 on the CPU, atol 1e-5.
Weights cross over through srcnn_from_jax / highresnet_from_jax, and through
a reference-format .pth written by the JAX exporters and read by the port's
own loader. Cases: 8 revisits and 3 (HighResNet pads them to 4), the median
reference frame on and off, and an antialiased downscale to output_size.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs import HighResNet as JaxHighResNet, SRCNN as JaxSRCNN
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.archs import SRCNN, HighResNet
from satlas_sr_tpu_torch.utils.checkpoint import load_network_variables
from satlas_sr_tpu_torch.utils.torch_io import highresnet_from_jax, srcnn_from_jax
from torch_threads import two_torch_threads  # noqa: F401

HW = 8
ARCHS = {"SRCNN": (JaxSRCNN, SRCNN, srcnn_from_jax, jax_torch_io.srcnn_to_torch),
         "HighResNet": (JaxHighResNet, HighResNet, highresnet_from_jax,
                        jax_torch_io.highresnet_to_torch)}


def _jitter(variables, seed):
    """Non-zero biases and PReLU slopes everywhere, so each one is wired."""
    key = [jax.random.PRNGKey(seed)]

    def f(path, leaf):
        if path[-1].key == "kernel":
            return leaf
        key[0], sub = jax.random.split(key[0])
        return leaf + 0.05 * jax.random.normal(sub, leaf.shape, leaf.dtype)

    return jax.tree_util.tree_map_with_path(f, variables)


def _cfg(revisits, use_ref, output_size):
    return dict(in_channels=3, revisits=revisits, hidden_channels=16, out_channels=3,
                kernel_size=3, residual_layers=1, output_size=output_size, zoom_factor=4,
                sr_kernel_size=1, use_reference_frame=use_ref)


@pytest.mark.parametrize("arch", ["SRCNN", "HighResNet"])
@pytest.mark.parametrize("revisits,use_ref,output_size", [
    (8, False, 20),   # antialiased downscale 32 -> 20
    (3, True, 32),    # odd revisits (HighResNet zero-pads to 4), median frame;
                      # resize is the identity, as in the zoo configs
])
def test_port_matches_jax(rng, tmp_path, arch, revisits, use_ref, output_size):
    jax_cls, port_cls, from_jax, to_torch = ARCHS[arch]
    cfg = _cfg(revisits, use_ref, output_size)
    x = rng.rand(2, revisits, HW, HW, 3).astype(np.float32)
    jm = jax_cls(**cfg)
    v = _jitter(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    assert want.shape == (2, 1, output_size, output_size, 3)

    path = str(tmp_path / "net_g.pth")
    jax_torch_io.save_torch_state_dict(path, to_torch(v), param_key="params_ema")
    for state in (from_jax(jax.tree.map(np.asarray, v)),
                  load_network_variables(arch, path, param_key="params_ema")):
        model = port_cls(device="cpu", **cfg)
        model.load_state_dict(state)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_srcnn_mask_encoder_matches_jax(rng):
    """mask_channels > 0: OneHot(12) -> DoubleConv2d -> sigmoid joins the fusion."""
    cfg = dict(_cfg(4, False, 32), mask_channels=1)
    x = rng.rand(1, 4, HW, HW, 3).astype(np.float32)
    mask = rng.randint(0, 12, (1, 4, HW, HW, 1)).astype(np.float32)
    jm = JaxSRCNN(**cfg)
    v = _jitter(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), mask=jnp.asarray(mask)), 2)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x), mask=jnp.asarray(mask)))
    model = SRCNN(device="cpu", **cfg)
    model.load_state_dict(srcnn_from_jax(jax.tree.map(np.asarray, v)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
        with pytest.raises(ValueError, match="pass a mask"):
            model(torch.from_numpy(x))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="no mask"):
        HighResNet(device="cpu", **cfg)


def test_state_dict_names_are_the_reference_names():
    cfg = _cfg(8, False, 32)
    s = set(SRCNN(device="cpu", **cfg).state_dict())
    assert {"encoder.doubleconv2d.0.weight", "encoder.doubleconv2d.2.weight",
            "doubleconv2d.doubleconv2d.4.bias", "residualblocks.0.residualblock.doubleconv2d.6.weight",
            "sr.upsample.1.weight", "sr.upsample.6.weight"} <= s
    h = set(HighResNet(device="cpu", **cfg).state_dict())
    assert {"fusion.fusion.0.fuse.0.residualblock.doubleconv2d.0.weight",
            "fusion.fusion.0.fuse.1.weight", "fusion.fusion.0.fuse.3.weight"} <= h
    assert not any(k.startswith(("fusion.fusion.1", "doubleconv2d", "residualblocks")) for k in h)


def test_highresnet_pth_with_one_name_per_level_loads(rng, tmp_path):
    """A .pth naming the shared FusionBlock once per level loads (level 0
    kept); one whose levels differ is refused."""
    from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict

    cfg = _cfg(8, False, 32)
    state = HighResNet(seed=3, device="cpu", **cfg).state_dict()
    per_level = dict(state)
    for lvl in (1, 2):
        per_level.update({k.replace("fusion.fusion.0.", f"fusion.fusion.{lvl}."): v.clone()
                          for k, v in state.items() if k.startswith("fusion.fusion.0.")})
    path = str(tmp_path / "h.pth")
    save_torch_state_dict(path, per_level, param_key="params")
    loaded = load_network_variables("HighResNet", path)
    assert set(loaded) == set(state)
    per_level["fusion.fusion.2.fuse.1.bias"] += 1
    save_torch_state_dict(path, per_level, param_key="params")
    with pytest.raises(ValueError, match="shares one FusionBlock"):
        load_network_variables("HighResNet", path)


def test_blocks_and_ops_match_jax(rng):
    from satlas_sr_tpu.archs.blocks import OneHot as JaxOneHot
    from satlas_sr_tpu.ops.median import lower_median as jax_median
    from satlas_sr_tpu.ops.resize import resize_bilinear as jax_resize
    from satlas_sr_tpu_torch.archs.blocks import OneHot
    from satlas_sr_tpu_torch.ops.median import lower_median
    from satlas_sr_tpu_torch.ops.resize import resize_bilinear

    for t in (4, 5):  # even count: the lower middle element, not the mean
        x = rng.rand(2, t, 3, 3, 2).astype(np.float32)
        np.testing.assert_array_equal(lower_median(torch.from_numpy(x), 1, keepdim=True).numpy(),
                                      np.asarray(jax_median(jnp.asarray(x), 1, keepdims=True)))
    m = rng.randint(0, 12, (2, 5, 5, 1))
    np.testing.assert_array_equal(
        OneHot(12)(torch.from_numpy(m).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
        np.asarray(JaxOneHot(12)(jnp.asarray(m))))
    x = rng.rand(1, 32, 32, 3).astype(np.float32)
    for out_hw, aa in (((20, 20), True), ((48, 40), False), ((24, 40), True), ((32, 32), True)):
        np.testing.assert_allclose(resize_bilinear(torch.from_numpy(x), out_hw, aa).numpy(),
                                   np.asarray(jax_resize(jnp.asarray(x), out_hw, aa)), atol=1e-6)

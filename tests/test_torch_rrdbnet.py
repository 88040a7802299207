"""The port's RRDBNet against the JAX RRDBNet.apply (fused, XLA path).

Tiny widths (nf=16, g=8, 2 blocks), float32 on the CPU, atol/rtol 1e-4:
the same convolutions in another summation order through a 2-block trunk
and the heads. Weights cross over both through rrdbnet_from_jax and through
a reference-format .pth read by the port's own loader.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs import RRDBNet as JaxRRDBNet
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.archs import RRDBNet
from satlas_sr_tpu_torch.ops.pixelshuffle import pixel_unshuffle
from satlas_sr_tpu_torch.ops.resize import upsample_nearest
from satlas_sr_tpu_torch.utils.checkpoint import load_network_variables
from satlas_sr_tpu_torch.utils.torch_io import rrdbnet_from_jax
from torch_threads import two_torch_threads  # noqa: F401

TINY = dict(num_in_ch=6, num_out_ch=3, num_feat=16, num_block=2, num_grow_ch=8)


def _jax_model(rng, scale):
    m = JaxRRDBNet(scale=scale, **TINY)
    x = rng.rand(2, 32, 32, TINY["num_in_ch"]).astype(np.float32)
    v = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # non-zero biases everywhere, so every bias is wired
    key = [jax.random.PRNGKey(2)]

    def jitter(path, leaf):
        if path[-1].key != "bias":
            return leaf
        key[0], sub = jax.random.split(key[0])
        return 0.05 * jax.random.normal(sub, leaf.shape, leaf.dtype)

    v = jax.tree_util.tree_map_with_path(jitter, v)
    return m, v, x


def _port(scale, state):
    model = RRDBNet(scale=scale, device="cpu", **TINY)
    model.load_state_dict(state)
    return model.eval()


@pytest.mark.parametrize("scale", [4, 2])
def test_rrdbnet_matches_jax(rng, tmp_path, scale):
    """Through rrdbnet_from_jax, and through a .pth saved under `params` and
    read with param_key params_ema (the params_ema -> params fallback)."""
    m, v, x = _jax_model(rng, scale)
    want = np.asarray(m.apply(v, jnp.asarray(x)))
    path = str(tmp_path / "net_g.pth")
    jax_torch_io.save_torch_state_dict(path, jax_torch_io.rrdbnet_to_torch(v), param_key="params")
    for state in (rrdbnet_from_jax(jax.tree.map(np.asarray, v)),
                  load_network_variables("SSR_RRDBNet", path, param_key="params_ema")):
        with torch.no_grad():
            got = _port(scale, state)(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 32 * scale, 32 * scale, 3)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_state_dict_names_are_the_reference_names():
    names = set(RRDBNet(scale=16, device="cpu", **TINY).state_dict())
    assert {"conv_first.weight", "body.1.rdb3.conv5.bias", "conv_up4.weight",
            "conv_hr.bias", "conv_last.weight"} <= names
    assert len(names) == 2 * (8 + TINY["num_block"] * 3 * 5)


def test_seeded_init_is_deterministic():
    a = RRDBNet(seed=3, device="cpu", **TINY).state_dict()
    b = RRDBNet(seed=3, device="cpu", **TINY).state_dict()
    c = RRDBNet(seed=4, device="cpu", **TINY).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_first.weight"], c["conv_first.weight"])


def test_msgpack_weights_not_yet_ported(tmp_path):
    """A JAX-layout net_g .msgpack (once refused) loads: the port's own
    writer and reader round-trip the EMA exactly, `param_key` picking it."""
    from satlas_sr_tpu_torch.utils.checkpoint import save_pytree
    from satlas_sr_tpu_torch.utils.torch_io import rrdbnet_to_jax

    raw = RRDBNet(seed=3, device="cpu", **TINY).state_dict()
    ema = RRDBNet(seed=4, device="cpu", **TINY).state_dict()
    path = str(tmp_path / "net_g.msgpack")
    save_pytree(path, {"params": rrdbnet_to_jax(raw)["params"],
                       "params_ema": rrdbnet_to_jax(ema)["params"]})
    for key, want in (("params_ema", ema), ("params", raw)):
        got = load_network_variables("SSR_RRDBNet", path, None, key)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_resize_and_pixelshuffle_match_jax(rng):
    from satlas_sr_tpu.ops.pixelshuffle import pixel_unshuffle as jax_unshuffle
    from satlas_sr_tpu.ops.resize import upsample_nearest as jax_upsample

    x = rng.rand(2, 8, 8, 6).astype(np.float32)
    np.testing.assert_array_equal(upsample_nearest(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jax_upsample(jnp.asarray(x), 2)))
    for r in (2, 4):
        np.testing.assert_array_equal(pixel_unshuffle(torch.from_numpy(x), r).numpy(),
                                      np.asarray(jax_unshuffle(jnp.asarray(x), r)))

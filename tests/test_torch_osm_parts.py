"""The OSM-object trainer's parts in the port against the JAX package's, on
the CPU in float32: `crop_resize_boxes` (ops/crop.py), `SelfAttentionBlock`
and `OSMObjDiscriminator` (archs/osm_discriminator.py) and their weights'
way across (`osm_disc_from_jax`, the reference .pth names both ways).

- crops: forward within 1e-6, the image gradient within 1e-5 (absolute,
  plus 1e-5 relative where a pixel gathers many samples), on boxes
  that span the image, touch its edges, are one pixel wide, or are
  degenerate as they come (x1 == x2);
- attention and the discriminator: forward within 1e-5 (gamma set non-zero,
  or the branch is the identity), the spectral u/v after one power
  iteration within 1e-6. The port's seeded weights go to flax through the
  JAX package's reference-.pth importer (`osm_disc_from_torch`), and come
  back through `osm_disc_from_jax` unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs.osm_discriminator import OSMObjDiscriminator as JaxOSMDisc
from satlas_sr_tpu.archs.osm_discriminator import SelfAttentionBlock as JaxAttention
from satlas_sr_tpu.ops.crop import crop_resize_boxes as jax_crop
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.archs import OSMObjDiscriminator, SelfAttentionBlock
from satlas_sr_tpu_torch.ops.crop import crop_resize_boxes
from satlas_sr_tpu_torch.utils.checkpoint import load_network_variables
from satlas_sr_tpu_torch.utils.torch_io import (osm_disc_from_jax, osm_disc_from_reference,
                                                osm_disc_to_reference, save_torch_state_dict)
from torch_threads import two_torch_threads  # noqa: F401

BOXES = [[[0, 0, 128, 128], [120, 5, 128, 9], [10, 10, 11, 40]],
         [[127, 127, 128, 128], [30, 40, 30, 90], [0, 100, 57, 128]]]


def _numpy(state):
    return {k: v.detach().numpy() for k, v in state.items()}


def test_crop_resize_boxes_matches_jax(rng):
    img = rng.rand(2, 128, 128, 3).astype(np.float32)
    weight = rng.randn(2, 3, 32, 32, 3).astype(np.float32)
    boxes = np.asarray(BOXES, np.int32)
    x = torch.from_numpy(img).requires_grad_()
    got = crop_resize_boxes(x, torch.from_numpy(boxes))
    (got * torch.from_numpy(weight)).sum().backward()
    want, vjp = jax.vjp(lambda i: jax_crop(i, jnp.asarray(boxes)), jnp.asarray(img))
    (want_grad,) = vjp(jnp.asarray(weight))
    assert got.shape == (2, 3, 32, 32, 3)
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= 1e-6
    # the scatter-add sums up to 1024 samples into one pixel (the 1x1 box)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-5, rtol=1e-5)


def test_crop_of_a_bfloat16_image_computes_in_float32(rng):
    img = torch.from_numpy(rng.rand(1, 128, 128, 3).astype(np.float32)).bfloat16()
    boxes = torch.tensor([BOXES[0]], dtype=torch.int32)
    got = crop_resize_boxes(img, boxes)
    assert got.dtype == torch.float32
    assert torch.equal(got, crop_resize_boxes(img.float(), boxes))


def _attention_params(block):
    conv = lambda c: {"kernel": np.transpose(c.weight.detach().numpy(), (2, 3, 1, 0)),
                      "bias": c.bias.detach().numpy()}
    return {"query": conv(block.query_conv), "key": conv(block.key_conv),
            "value": conv(block.value_conv), "gamma": block.gamma.detach().numpy()}


def test_self_attention_matches_jax(rng):
    block = SelfAttentionBlock(16, torch.Generator().manual_seed(0))
    with torch.no_grad():
        block.gamma.fill_(0.7)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    want = JaxAttention(16).apply({"params": _attention_params(block)}, jnp.asarray(x))
    assert np.abs(got - np.asarray(want)).max() <= 1e-5
    with torch.no_grad():  # gamma starts at 0: the block starts as the identity
        fresh = SelfAttentionBlock(16, torch.Generator().manual_seed(0))
        assert torch.equal(fresh(torch.from_numpy(x)), torch.from_numpy(x))


@pytest.fixture(scope="module")
def osm_disc():
    port = OSMObjDiscriminator(9, 4, seed=3, device="cpu")
    with torch.no_grad():
        port.o_attention1.gamma.fill_(0.5)
        port.o_attention2.gamma.fill_(-0.3)
    reference = osm_disc_to_reference(port.state_dict())
    return port, reference, jax_torch_io.osm_disc_from_torch(_numpy(reference))


def test_osm_discriminator_matches_jax(rng, osm_disc):
    port, _, variables = osm_disc
    x = rng.rand(2, 64, 64, 9).astype(np.float32)
    objs = rng.rand(6, 32, 32, 3).astype(np.float32)
    apply = jax.jit(lambda v, x, o: JaxOSMDisc(9, 4).apply(v, x, o, update_stats=True,
                                                            mutable=["spectral"]))
    (want_img, want_obj), mut = apply(variables, jnp.asarray(x), jnp.asarray(objs))
    with torch.no_grad():
        got_img, got_obj = port(torch.from_numpy(x), torch.from_numpy(objs), update_stats=True)
    assert got_img.shape == (2, 64, 64, 1) and got_obj.shape == (6, 2, 2, 1)
    assert (got_obj >= 0).all()  # the ReLU on the object logits
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_obj.numpy(), np.asarray(want_obj), atol=1e-5, rtol=0)
    spectral = osm_disc_from_jax({"params": variables["params"],
                                  "spectral": jax.device_get(mut["spectral"])})
    state = port.state_dict()
    uv = [k for k in spectral if k.endswith(("weight_u", "weight_v"))]
    assert len(uv) == 16
    for k in uv:
        assert np.abs(state[k].numpy() - spectral[k].numpy()).max() <= 1e-6, k


def test_weights_cross_both_ways(osm_disc, tmp_path):
    port, reference, variables = osm_disc
    state = port.state_dict()
    assert any(k.startswith("unet.conv1.") for k in state)
    assert set(reference) == set(jax_torch_io.osm_disc_to_torch(variables))
    assert not any(k.startswith("unet.") for k in reference)
    back = osm_disc_from_jax(jax.device_get(variables))
    assert set(back) == set(state) == set(osm_disc_from_reference(reference))
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    path = str(tmp_path / "net_d.pth")
    save_torch_state_dict(path, reference, "params")
    loaded = load_network_variables("OSMObjDiscriminator", path, {}, "params")
    fresh = OSMObjDiscriminator(9, 4, seed=9, device="cpu")
    fresh.load_state_dict(loaded)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in state.items())
    imported = jax_torch_io.import_torch_checkpoint("OSMObjDiscriminator", path, {}, "params")
    assert jax.tree.all(jax.tree.map(np.array_equal, imported, variables))

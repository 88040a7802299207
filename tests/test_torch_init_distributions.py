"""The port's seed-0 initial weights against the JAX package's, conv kernel by
conv kernel, at the published widths (RRDBNet 24 -> 3, nf 64, gc 32, 23
blocks; the U-Net SN discriminator at 27 input channels, nf 64; the
OSM-object discriminator of options/osm_obj_esrgan.yml, its U-Net at 27
input channels, nf 64, and its object branch), on the CPU.

The two draws come from different generators, so they are held as
distributions, not values:
- each kernel's standard deviation within 3% of JAX's, or, for a kernel
  too small for two draws to agree that closely, within three standard
  errors of the ratio of two sample deviations, 3 / sqrt(n) for n weights
  (the D's 1-channel head has 576, conv_last 1728);
- the truncation the same: where JAX's draw is bounded (flax's default
  lecun_normal truncates at 2.27 sigma, the spectral-norm convs' uniform
  init at 1.73 sigma), the port's largest |w| / sigma is within that bound
  too; where JAX's draw is an untruncated normal (the dense-block convs,
  max |w| / sigma near 4 over ~2e4 weights), the port's is also beyond it.
Every kernel is held so, the discriminators' heads (conv0, conv9) and the
OSM D's object branch and attention convs included: they draw flax's
lecun_normal as the JAX nn.Conv does. The JAX inits run under jax.jit (a
few seconds each at full depth).
"""

import math

import jax
import jax.numpy as jnp
import pytest

from satlas_sr_tpu.archs.discriminator import UNetDiscriminatorSN as JaxUNet
from satlas_sr_tpu.archs.osm_discriminator import OSMObjDiscriminator as JaxOSMDisc
from satlas_sr_tpu.archs.rrdbnet import RRDBNet as JaxRRDBNet
from satlas_sr_tpu_torch.archs import RRDBNet
from satlas_sr_tpu_torch.archs.discriminator import UNetDiscriminatorSN
from satlas_sr_tpu_torch.archs.osm_discriminator import OSMObjDiscriminator
from satlas_sr_tpu_torch.utils.torch_io import (osm_disc_from_jax, rrdbnet_from_jax,
                                                unet_disc_from_jax)
from torch_threads import two_torch_threads  # noqa: F401

#: flax's truncated normal reaches 2 / 0.8796 = 2.2737 sigma; an untruncated
#: draw of the kernels here exceeds this bound
BOUNDED = 2.2737 * 1.03


def _jax_init(module, *inputs):
    return jax.device_get(jax.jit(lambda k: module.init(k, *inputs))(jax.random.PRNGKey(0)))


NETS = {
    "generator": lambda: (
        rrdbnet_from_jax(_jax_init(JaxRRDBNet(num_in_ch=24, num_out_ch=3, num_feat=64,
                                              num_block=23, num_grow_ch=32, scale=4),
                                   jnp.zeros((1, 32, 32, 24)))),
        RRDBNet(scale=4, num_in_ch=24, num_out_ch=3, seed=0, device="cpu").state_dict()),
    "unet_d": lambda: (
        unet_disc_from_jax(_jax_init(JaxUNet(num_in_ch=27, num_feat=64),
                                     jnp.zeros((1, 128, 128, 27)))),
        UNetDiscriminatorSN(27, seed=0, device="cpu").state_dict()),
    "osm_d": lambda: (
        osm_disc_from_jax(_jax_init(JaxOSMDisc(num_in_ch=27, num_feat=64),
                                    jnp.zeros((1, 128, 128, 27)), jnp.zeros((2, 32, 32, 3)))),
        OSMObjDiscriminator(27, seed=0, device="cpu").state_dict()),
}


@pytest.mark.parametrize("net", sorted(NETS))
def test_conv_kernels_are_drawn_as_jax_draws_them(net):
    want, got = NETS[net]()
    kernels = [k for k, v in want.items() if v.ndim == 4]
    assert kernels and set(kernels) <= set(got)
    for name in kernels:
        a, b = want[name].double(), got[name].double()
        assert a.shape == b.shape, name
        sa, sb = a.std().item(), b.std().item()
        tol = max(0.03, 3.0 / math.sqrt(a.numel()))
        assert abs(sb / sa - 1.0) <= tol, (name, sa, sb, tol)
        ra, rb = a.abs().max().item() / sa, b.abs().max().item() / sb
        assert (ra <= BOUNDED) == (rb <= BOUNDED), (name, ra, rb)
        if ra <= BOUNDED:
            assert rb <= ra * 1.03 + 1e-3, (name, ra, rb)

"""OSM-object discriminator: the U-Net SN discriminator and an object branch
with self-attention (the JAX package's `archs/osm_discriminator.py`;
ssr/archs/osm_obj_discriminator_arch.py:34-108).

`forward(x, osm_objs)` returns (per-pixel logits of x, object logits of the
32x32 crops): the object branch is four 4x4 stride-2 convs (64, 128, 256, 1
channels) with ReLUs, a SelfAttentionBlock after the second and the third,
and a ReLU on the logits too (the reference's quirk, kept). The U-Net sits
under `unet` and alone carries spectral norm; the reference .pth names its
convs at the top level (utils/torch_io.py renames them both ways).

NHWC in and out. Parameters are float32, made on the CPU from a
torch.Generator seeded by `seed`; convs run in `dtype` (x's own when None).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .discriminator import UNetDiscriminatorSN


def _conv(cin: int, cout: int, k: int, gen: torch.Generator, **kw) -> nn.Conv2d:
    """nn.Conv2d at flax's default init scale (normal, 1/sqrt(fan_in)), zero bias."""
    c = nn.Conv2d(cin, cout, k, **kw)
    with torch.no_grad():
        c.weight.normal_(0.0, 1.0 / math.sqrt(cin * k * k), generator=gen)
        c.bias.zero_()
    return c


def _nhwc_conv(c: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), c.weight.to(x.dtype), c.bias.to(x.dtype),
                 stride=c.stride, padding=c.padding)
    return y.permute(0, 2, 3, 1)


class SelfAttentionBlock(nn.Module):
    """Softmax self-attention over the spatial positions with a gamma-gated
    residual: 1x1 query/key (C/8) and value (C) convs, energy q_i . k_j with
    no 1/sqrt(d) scale, in float32, softmax over j in float32, then cast to
    v's dtype. gamma starts at 0."""

    def __init__(self, channels: int, gen: torch.Generator):
        super().__init__()
        self.query_conv = _conv(channels, channels // 8, 1, gen)
        self.key_conv = _conv(channels, channels // 8, 1, gen)
        self.value_conv = _conv(channels, channels, 1, gen)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        q = _nhwc_conv(self.query_conv, x).reshape(b, h * w, c // 8)
        k = _nhwc_conv(self.key_conv, x).reshape(b, h * w, c // 8)
        v = _nhwc_conv(self.value_conv, x).reshape(b, h * w, c)
        energy = torch.bmm(q.float(), k.float().transpose(1, 2))
        attn = torch.softmax(energy, dim=2).to(v.dtype)
        out = torch.bmm(attn, v).reshape(b, h, w, c).to(x.dtype)
        return self.gamma.to(x.dtype) * out + x


class OSMObjDiscriminator(nn.Module):
    def __init__(self, num_in_ch: int, num_feat: int = 64, skip_connection: bool = True,
                 seed: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.unet = UNetDiscriminatorSN(num_in_ch, num_feat, skip_connection, seed=seed,
                                        device="cpu")
        gen = torch.Generator().manual_seed(seed + 1)
        down = dict(stride=2, padding=1)
        self.o_conv1 = _conv(3, 64, 4, gen, **down)
        self.o_conv2 = _conv(64, 128, 4, gen, **down)
        self.o_attention1 = SelfAttentionBlock(128, gen)
        self.o_conv3 = _conv(128, 256, 4, gen, **down)
        self.o_attention2 = SelfAttentionBlock(256, gen)
        self.o_conv4 = _conv(256, 1, 4, gen, **down)
        self.to(device)

    def forward(self, x: torch.Tensor, osm_objs: torch.Tensor, update_stats: bool = False,
                dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, H, W, num_in_ch], osm_objs [N, 32, 32, 3] -> (logits [B, H, W, 1],
        object logits [N, 2, 2, 1]), computed in `dtype`."""
        obj_logits = self._objects(osm_objs, dtype)
        return self.unet(x, update_stats=update_stats, dtype=dtype), obj_logits

    def _objects(self, osm_objs: torch.Tensor, dtype) -> torch.Tensor:
        """The object branch: crops [N, 32, 32, 3] -> logits [N, 2, 2, 1]."""
        o = osm_objs.to(dtype or osm_objs.dtype)
        o = torch.relu(_nhwc_conv(self.o_conv1, o))
        o = torch.relu(_nhwc_conv(self.o_conv2, o))
        o = self.o_attention1(o)
        o = torch.relu(_nhwc_conv(self.o_conv3, o))
        o = self.o_attention2(o)
        return torch.relu(_nhwc_conv(self.o_conv4, o))

    BAND_FACTOR = UNetDiscriminatorSN.BAND_FACTOR

    def forward_band(self, x: torch.Tensor, osm_objs: torch.Tensor, space,
                     update_stats: bool = False,
                     dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """`forward` with x this rank's row band of an image split over
        `space`: the band's logits; the object branch runs whole on the
        crops, which the caller takes from the gathered image."""
        obj_logits = self._objects(osm_objs, dtype)
        return self.unet.forward_band(x, space, update_stats=update_stats, dtype=dtype), obj_logits

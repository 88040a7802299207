"""U-Net discriminator with spectral norm (the JAX package's `archs/discriminator.py`).

Real-ESRGAN's SSR_UNetDiscriminatorSN (ssr/archs/discriminator_arch.py:11-71):
conv0, three stride-2 4x4 SN convs down, three bilinear x2 upsamples each
followed by an SN conv with a skip add, two more SN convs and a 3x3 head
giving one logit per pixel. NHWC in and out. Module and buffer names are the
reference .pth's (conv0, conv1..8.weight_orig/_u/_v, conv9).

Parameters are float32 and made on the CPU from a torch.Generator seeded by
`seed`: the spectral-norm convs as the JAX SNConv draws them (uniform in
+-1/sqrt(fan_in)), and conv0 and conv9 as the JAX nn.Conv draws them,
flax's truncated lecun_normal (`inits.lecun_normal_`), with zero biases.
Every conv runs in x's dtype after casting, with the upsamples in float32,
so a bfloat16 train step keeps float32 master weights. The
bilinear x2 upsamples (`up2_bilinear`) are fixed-weight shifted sums, not
F.interpolate, whose backward on the card accumulates with atomics and so
varies from run to run: the sums' backward has no scatter, and a train
run repeats bit for bit. `update_stats=True` runs one power iteration per SN
conv and writes its u/v buffers. `forward_band` is the forward of one rank's
row band (the train step on a dp x sp layout), sharing the modules.
"""

from __future__ import annotations


import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.cuda.rdb import point_two
from ..ops.spectral_norm import SNConv
from ..parallel.halo import conv2d_band, pad_rows
from .inits import lecun_normal_


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, point_two(x.dtype))


def _up2_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bilinear x2 along `dim` (half-pixel centres, edges clamped): output
    2i = 0.75 x[i] + 0.25 x[i - 1] and 2i + 1 = 0.75 x[i] + 0.25 x[i + 1]."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even, odd = 0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def up2_bilinear_band(x: torch.Tensor, space) -> torch.Tensor:
    """`up2_bilinear` of this rank's row band: one row of each neighbour
    band, the edge row clamped only on the image's own border."""
    h = x.shape[1]
    ext = pad_rows(x, 1, 1, space, dim=1, border="edge").float()
    mid = ext[:, 1:h + 1]
    even, odd = 0.75 * mid + 0.25 * ext[:, :h], 0.75 * mid + 0.25 * ext[:, 2:]
    rows = torch.stack([even, odd], 2).flatten(1, 2)
    return _up2_axis(rows, 2).to(x.dtype)


def up2_bilinear(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, 2H, 2W, C]: F.interpolate's bilinear x2
    (align_corners=False) as shifted sums in H, then W, in float32; returns
    x's dtype."""
    return _up2_axis(_up2_axis(x.float(), 1), 2).to(x.dtype)



class UNetDiscriminatorSN(nn.Module):
    def __init__(self, num_in_ch: int, num_feat: int = 64, skip_connection: bool = True,
                 seed: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.skip_connection = skip_connection
        gen = torch.Generator().manual_seed(seed)
        nf = num_feat

        def conv(cin, cout):  # flax's nn.Conv init: lecun_normal, zero bias
            c = nn.Conv2d(cin, cout, 3, padding=1)
            lecun_normal_(c.weight, gen)
            nn.init.zeros_(c.bias)
            return c

        sn = lambda cin, cout, k, s: SNConv(cin, cout, k, s, 1, bias=False, generator=gen)
        self.conv0 = conv(num_in_ch, nf)
        self.conv1 = sn(nf, nf * 2, 4, 2)
        self.conv2 = sn(nf * 2, nf * 4, 4, 2)
        self.conv3 = sn(nf * 4, nf * 8, 4, 2)
        self.conv4 = sn(nf * 8, nf * 4, 3, 1)
        self.conv5 = sn(nf * 4, nf * 2, 3, 1)
        self.conv6 = sn(nf * 2, nf, 3, 1)
        self.conv7 = sn(nf, nf, 3, 1)
        self.conv8 = sn(nf, nf, 3, 1)
        self.conv9 = conv(nf, 1)
        self.to(device)

    @staticmethod
    def _conv(c: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), c.weight.to(x.dtype), c.bias.to(x.dtype), padding=1)
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                dtype: torch.dtype = None) -> torch.Tensor:
        """x [B, H, W, num_in_ch] -> logits [B, H, W, 1], computed in `dtype`
        (x's own when None)."""
        x = x.to(dtype or x.dtype)
        x0 = _lrelu(self._conv(self.conv0, x))
        x1 = _lrelu(self.conv1(x0, update_stats))
        x2 = _lrelu(self.conv2(x1, update_stats))
        x3 = _lrelu(self.conv3(x2, update_stats))
        x4 = _lrelu(self.conv4(up2_bilinear(x3), update_stats))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = _lrelu(self.conv5(up2_bilinear(x4), update_stats))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = _lrelu(self.conv6(up2_bilinear(x5), update_stats))
        if self.skip_connection:
            x6 = x6 + x0
        out = _lrelu(self.conv7(x6, update_stats))
        out = _lrelu(self.conv8(out, update_stats))
        return self._conv(self.conv9, out)

    #: the rows of an input band must divide by this (three stride-2 convs)
    BAND_FACTOR = 8

    def forward_band(self, x: torch.Tensor, space, update_stats: bool = False,
                     dtype: torch.dtype = None) -> torch.Tensor:
        """`forward` of this rank's row band x [B, h, W, C] of an image split
        over `space` (a mesh.SpaceLayout): the logits of the same rows. Every
        conv takes its halo rows from the neighbour bands (halo.conv2d_band:
        one row a side, the stride-2 convs one above and one below their
        band's even rows), each upsample one row at the lower resolution;
        h must divide by 8."""
        if x.shape[1] % self.BAND_FACTOR:
            raise ValueError(f"the U-Net discriminator's band of {x.shape[1]} rows does not "
                             f"divide by {self.BAND_FACTOR} (three stride-2 convs)")
        x = x.to(dtype or x.dtype)
        conv = lambda c, t: conv2d_band(t.permute(0, 3, 1, 2), c.weight.to(t.dtype),
                                        c.bias.to(t.dtype), space).permute(0, 2, 3, 1)
        sn = lambda c, t: c.forward_band(t, space, update_stats)
        up = lambda t: up2_bilinear_band(t, space)
        x0 = _lrelu(conv(self.conv0, x))
        x1 = _lrelu(sn(self.conv1, x0))
        x2 = _lrelu(sn(self.conv2, x1))
        x3 = _lrelu(sn(self.conv3, x2))
        x4 = _lrelu(sn(self.conv4, up(x3)))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = _lrelu(sn(self.conv5, up(x4)))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = _lrelu(sn(self.conv6, up(x5)))
        if self.skip_connection:
            x6 = x6 + x0
        out = _lrelu(sn(self.conv7, x6))
        out = _lrelu(sn(self.conv8, out))
        return conv(self.conv9, out)

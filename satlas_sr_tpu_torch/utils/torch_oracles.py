"""Independent PyTorch functional oracles for the released generators.

A copy of satlas_sr_tpu/utils/torch_oracles.py: the reference generators'
math (RRDBNet: ssr/archs/rrdbnet_arch.py:92-137; SRCNN/HighResNet:
ssr/archs/{srcnn,highresnet}_arch.py + arch_util.py blocks) run directly
from a torch-format state dict with torch.nn.functional only: no module
classes, none of the port's modules and not the RDB kernel. It is the
comparator of the port's acceptance command (acceptance.py), so agreement
with it on identical inputs is agreement with the reference forward, and a
fault in the port's modules or its kernel cannot hide in both sides.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _c(sd, name, x, pad=1, stride=1):
    w = sd[name + ".weight"]
    b = sd.get(name + ".bias")
    return F.conv2d(x, w, b, stride=stride, padding=pad)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def rrdbnet_forward(sd, x, num_block, scale=4):
    """NCHW float in [0,1] -> NCHW float; sd is a torch state dict."""

    def rdb(pfx, h):
        x1 = _lrelu(_c(sd, pfx + ".conv1", h))
        x2 = _lrelu(_c(sd, pfx + ".conv2", torch.cat([h, x1], 1)))
        x3 = _lrelu(_c(sd, pfx + ".conv3", torch.cat([h, x1, x2], 1)))
        x4 = _lrelu(_c(sd, pfx + ".conv4", torch.cat([h, x1, x2, x3], 1)))
        x5 = _c(sd, pfx + ".conv5", torch.cat([h, x1, x2, x3, x4], 1))
        return x5 * 0.2 + h

    def rrdb(pfx, h):
        out = rdb(pfx + ".rdb1", h)
        out = rdb(pfx + ".rdb2", out)
        out = rdb(pfx + ".rdb3", out)
        return out * 0.2 + h

    if scale == 2:
        x = F.pixel_unshuffle(x, 2)
    elif scale == 1:
        x = F.pixel_unshuffle(x, 4)
    feat = _c(sd, "conv_first", x)
    body = feat
    for i in range(num_block):
        body = rrdb(f"body.{i}", body)
    feat = feat + _c(sd, "conv_body", body)
    feat = _lrelu(_c(sd, "conv_up1",
                     F.interpolate(feat, scale_factor=2, mode="nearest")))
    feat = _lrelu(_c(sd, "conv_up2",
                     F.interpolate(feat, scale_factor=2, mode="nearest")))
    if scale in (8, 16):
        feat = _lrelu(_c(sd, "conv_up3",
                         F.interpolate(feat, scale_factor=2, mode="nearest")))
        if scale == 16:
            feat = _lrelu(_c(sd, "conv_up4",
                             F.interpolate(feat, scale_factor=2,
                                           mode="nearest")))
    return _c(sd, "conv_last", _lrelu(_c(sd, "conv_hr", feat)))


def _reflect_conv(sd, name, x, k):
    pad = (k - 1) // 2
    if pad:
        x = F.pad(x, (pad, k - 1 - pad, pad, k - 1 - pad), mode="reflect")
    return F.conv2d(x, sd[name + ".weight"], sd.get(name + ".bias"))


def _prelu(sd, name, x):
    return F.prelu(x, sd[name + ".weight"])


def _doubleconv(sd, base, x, k=3):
    x = _reflect_conv(sd, base + ".0", x, k)
    x = _prelu(sd, base + ".2", x)
    x = _reflect_conv(sd, base + ".4", x, k)
    x = _prelu(sd, base + ".6", x)
    return x  # dropout is identity in eval


def srcnn_forward(sd, x, hidden_channels, residual_layers, output_size, zoom, sr_k, k=3):
    b, t, c, h, w = x.shape
    enc = _doubleconv(sd, "encoder.doubleconv2d", x.reshape(b * t, c, h, w), k)
    enc = enc.reshape(b, t * hidden_channels, h, w)
    fused = _doubleconv(sd, "doubleconv2d.doubleconv2d", enc, k)
    for i in range(residual_layers):
        fused = fused + _doubleconv(
            sd, f"residualblocks.{i}.residualblock.doubleconv2d", fused, k
        )
    y = F.pixel_shuffle(fused, zoom)
    y = _prelu(sd, "sr.upsample.3", _reflect_conv(sd, "sr.upsample.1", y, sr_k))
    y = _prelu(sd, "sr.upsample.6", _reflect_conv(sd, "sr.upsample.4", y, sr_k))
    # kornia Resize(bilinear, antialias) is identity at same size
    assert y.shape[-1] == output_size
    return y[:, None]


def highresnet_forward(sd, x, hidden_channels, output_size, zoom, sr_k, k=3):
    b, t, c, h, w = x.shape
    enc = _doubleconv(sd, "encoder.doubleconv2d", x.reshape(b * t, c, h, w), k)
    enc = enc.reshape(b, t, hidden_channels, h, w)

    def fuse(z):
        bb, tt, cc, hh, ww = z.shape
        half = tt // 2
        first = z[:, :half].reshape(bb * half, cc, hh, ww)
        second = z[:, half:].reshape(bb * half, cc, hh, ww)
        pair = torch.cat([first, second], dim=1)
        r = pair + _doubleconv(sd, "fusion.fusion.0.fuse.0.residualblock.doubleconv2d", pair, k)
        r = _reflect_conv(sd, "fusion.fusion.0.fuse.1", r, k)
        r = _prelu(sd, "fusion.fusion.0.fuse.3", r)
        return r.reshape(bb, half, cc, hh, ww)

    z = enc
    while z.shape[1] > 1:
        z = fuse(z)
    fused = z[:, 0]
    y = F.pixel_shuffle(fused, zoom)
    y = _prelu(sd, "sr.upsample.3", _reflect_conv(sd, "sr.upsample.1", y, sr_k))
    y = _prelu(sd, "sr.upsample.6", _reflect_conv(sd, "sr.upsample.4", y, sr_k))
    assert y.shape[-1] == output_size
    return y[:, None]

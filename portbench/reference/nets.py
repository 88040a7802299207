"""The generator of the cells in plain PyTorch, over a state dict.

`rrdbnet`: Real-ESRGAN's RRDBNet (xinntao/Real-ESRGAN, basicsr
rrdbnet_arch.py) over channel-stacked frames, x4: conv_first, num_block
RRDBs of three 5-conv dense blocks (LeakyReLU 0.2, residuals scaled by
0.2), conv_body, two nearest x2 upsamples with convs, conv_hr, conv_last.

It takes and returns NHWC, and takes `conv` (F.conv2d's signature) so that
a control can swap in a lower-precision one, in every conv or, by
`trunk_conv`, in the dense blocks' convs alone.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Conv = Callable[..., torch.Tensor]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def rrdbnet(sd: Dict[str, torch.Tensor], x: torch.Tensor, num_block: int,
            conv: Conv = F.conv2d, trunk_conv: Optional[Conv] = None) -> torch.Tensor:
    """x [B, H, W, C_in] in [0, 1] -> [B, 4H, 4W, C_out]. `trunk_conv`, when
    given, computes the dense blocks' convs and `conv` the others."""
    trunk_conv = conv if trunk_conv is None else trunk_conv

    def c(name, h, cv=conv):
        return cv(h, sd[name + ".weight"], sd[name + ".bias"], padding=1)

    def rdb(pfx, h):
        feats = [h]
        for k in range(1, 5):
            feats.append(_lrelu(c(f"{pfx}.conv{k}", torch.cat(feats, 1), trunk_conv)))
        return c(f"{pfx}.conv5", torch.cat(feats, 1), trunk_conv) * 0.2 + h

    feat = c("conv_first", x.permute(0, 3, 1, 2))
    body = feat
    for i in range(num_block):
        out = body
        for j in (1, 2, 3):
            out = rdb(f"body.{i}.rdb{j}", out)
        body = out * 0.2 + body
    feat = feat + c("conv_body", body)
    for up in ("conv_up1", "conv_up2"):
        feat = _lrelu(c(up, F.interpolate(feat, scale_factor=2, mode="nearest")))
    return c("conv_last", _lrelu(c("conv_hr", feat))).permute(0, 2, 3, 1)

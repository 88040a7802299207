"""Resizing of NHWC tensors with PyTorch's semantics.

- `upsample_nearest`: integer nearest upsampling (each source pixel becomes a
  scale x scale block), as the RRDBNet upsample stages need; equal to
  F.interpolate(mode='nearest') at integer factors.
- `resize_bilinear`: bilinear with half-pixel centres (align_corners=False),
  edges clamped; with antialias, a downscaled axis uses the triangle kernel
  widened to the footprint (torch's and kornia's antialiased resize). It
  runs in float32 and returns x's dtype, and is the identity when the size
  is unchanged (the SRCNN/HighResNet heads of the shipped configs).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """[N, H, W, C] -> [N, H*scale, W*scale, C]."""
    if scale == 1:
        return x
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int], antialias: bool = False) -> torch.Tensor:
    """[N, H, W, C] -> [N, out_h, out_w, C]."""
    oh, ow = out_hw
    h, w = x.shape[1], x.shape[2]
    if (oh, ow) == (h, w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=antialias and (oh < h or ow < w))
    return y.permute(0, 2, 3, 1).to(x.dtype)

"""Resizing of NHWC tensors with PyTorch's semantics.

- `upsample_nearest`: integer nearest upsampling (each source pixel becomes a
  scale x scale block), as the RRDBNet upsample stages need; equal to
  F.interpolate(mode='nearest') at integer factors.
- `resize_nearest`: nearest resize to any size, F.interpolate's default
  mode, as the CLIP loss and CLIPScore resize their inputs (128 -> 256,
  128 -> 384). A gather of the source rows and columns (their indices kept on
  the device once per size); it keeps x's dtype.
- `resize_bilinear`: bilinear with half-pixel centres (align_corners=False),
  edges clamped; with antialias, a downscaled axis uses the triangle kernel
  widened to the footprint (torch's and kornia's antialiased resize). It
  runs in float32 and returns x's dtype, and is the identity when the size
  is unchanged (the SRCNN/HighResNet heads of the shipped configs).
- `resize_bilinear_band`: `resize_bilinear` of an image whose rows are split
  over a space group (parallel/mesh.mesh_2d), one row band a rank. The
  identity when the whole image's size is unchanged (every shipped config,
  and whole-tile inference); otherwise the bands are gathered, the whole
  image resized and this rank's band of the output kept: correct, not
  parallel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """[N, H, W, C] -> [N, H*scale, W*scale, C]."""
    if scale == 1:
        return x
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def nearest_index(out_size: int, in_size: int) -> np.ndarray:
    """Source index of each output row: floor(i * (in/out)) in float32, as
    the JAX package's `_nearest_matrix` computes it (in/out is rounded to
    float32 first, which matters where it is inexact, as 128/384 is)."""
    src = np.floor(np.arange(out_size, dtype=np.float32) * np.float32(in_size / out_size))
    return np.minimum(src.astype(np.int64), in_size - 1)


@functools.lru_cache(maxsize=16)
def _nearest_index_on(out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(nearest_index(out_size, in_size)).to(device)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[N, H, W, C] -> [N, out_h, out_w, C], nearest (not bilinear: the
    reference resizes with F.interpolate's default mode)."""
    oh, ow = out_hw
    h, w = x.shape[1], x.shape[2]
    if oh != h:
        x = x.index_select(1, _nearest_index_on(oh, h, x.device))
    if ow != w:
        x = x.index_select(2, _nearest_index_on(ow, w, x.device))
    return x


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int], antialias: bool = False) -> torch.Tensor:
    """[N, H, W, C] -> [N, out_h, out_w, C]."""
    oh, ow = out_hw
    h, w = x.shape[1], x.shape[2]
    if (oh, ow) == (h, w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=antialias and (oh < h or ow < w))
    return y.permute(0, 2, 3, 1).to(x.dtype)


def resize_bilinear_band(x: torch.Tensor, out_hw: Tuple[int, int], space,
                         antialias: bool = False) -> torch.Tensor:
    """This rank's band [N, h, W, C] of an image split over `space` ->
    its band of the whole image resized to out_hw (S must divide out_h)."""
    from ..parallel.halo import gather_rows

    oh, ow = out_hw
    if (oh, ow) == (x.shape[1] * space.space_size, x.shape[2]):
        return x
    r0, r1 = space.band(oh)
    return resize_bilinear(gather_rows(x, space), out_hw, antialias)[:, r0:r1]

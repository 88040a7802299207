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
  is F.interpolate's function computed as two dense [out, in] weight
  matrices, one an axis (`interp_matrix`: F.interpolate's weights, built
  in float64 and cached per size and device), applied by float32 matmuls
  with TF32 off: F.interpolate's backward accumulates with atomics on the
  card, a matmul's does not, so a train run through it repeats. It
  returns x's dtype, and is the identity when the size is unchanged (the
  SRCNN/HighResNet heads of the shipped configs).
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

from .usm import no_tf32


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


@functools.lru_cache(maxsize=32)
def interp_matrix(out_size: int, in_size: int, antialias: bool) -> np.ndarray:
    """[out, in] float64 weights of F.interpolate(mode='bilinear',
    align_corners=False) along one axis; with `antialias`, those of its
    antialiased kernel (ATen's `_compute_indices_min_size_weights_aa`: the
    triangle filter over a support widened by in/out when downsizing,
    normalised over the taps inside the input). The coordinates and weights
    are computed in float32, as ATen computes them for a float32 input (the
    plain kernel's source coordinate as one fused multiply-add)."""
    f = np.float32
    scale = f(in_size / out_size)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        if antialias:
            support = scale if scale >= 1.0 else f(1.0)
            invscale = f(1.0) / scale if scale >= 1.0 else f(1.0)
            center = scale * f(i + 0.5)
            lo = max(int(center - support + f(0.5)), 0)
            hi = min(int(center + support + f(0.5)), in_size)
            taps = np.maximum(f(0.0), f(1.0) - np.abs(
                (np.arange(lo, hi, dtype=f) - center + f(0.5)) * invscale))
            total = f(0.0)
            for t in taps:
                total = total + t
            if total != 0.0:
                m[i, lo:hi] = taps / total
        else:
            src = max(f(float(scale) * (i + 0.5) - 0.5), f(0.0))  # exact in float64, rounded once
            i0 = int(src)
            i1 = i0 + 1 if i0 < in_size - 1 else i0
            l1 = src - f(i0)
            m[i, i0] += f(1.0) - l1
            m[i, i1] += l1
    return m


@functools.lru_cache(maxsize=32)
def _interp_on(out_size: int, in_size: int, antialias: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(interp_matrix(out_size, in_size, antialias)).float().to(device)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int], antialias: bool = False) -> torch.Tensor:
    """[N, H, W, C] -> [N, out_h, out_w, C]."""
    oh, ow = out_hw
    h, w = x.shape[1], x.shape[2]
    if (oh, ow) == (h, w):
        return x
    aa = antialias and (oh < h or ow < w)  # F.interpolate's flag covers both axes
    y = x.float()
    with no_tf32():
        y = torch.einsum("oh,nhwc->nowc", _interp_on(oh, h, aa, x.device), y)
        y = torch.einsum("pw,nhwc->nhpc", _interp_on(ow, w, aa, x.device), y)
    return y.to(x.dtype)


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

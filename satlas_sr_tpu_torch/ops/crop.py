"""Differentiable crop-and-resize of OSM object boxes (the JAX package's
`ops/crop.py`).

The reference crops each sampled OSM box out of the GT and the generator's
output and resizes it to 32x32 (ssr/models/osm_objs_esrgan_model.py:163-186).
Boxes come as a [B, K, 4] integer tensor (x1, y1, x2, y2), so the output has
a static shape [B, K, S, S, C]. Sampling is torchvision's tensor resize of
the boxed region: bilinear, half-pixel centres, no antialias, the source
coordinates clamped to the box's interior and then to the image.

The 4-tap bilinear sample is written as two weight matrices a box, rows
[B, K, S, H] and columns [B, K, S, W], each row holding the two taps of one
output coordinate, contracted with the image in float32 by matmuls (TF32
off). The image's gradient is then two matmuls too: a gather by advanced
indexing would give it as an index scatter-add, which accumulates with
atomics on the card, so a train run would not repeat.
"""

from __future__ import annotations

import torch

from .usm import no_tf32


def _tap_matrix(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[..., S] source coordinates in [0, size - 1] -> [..., S, size]: the
    linear-interpolation weights of the two taps around each coordinate."""
    i0 = coord.floor().long()
    i1 = (i0 + 1).clamp(max=size - 1)
    frac = (coord - i0)[..., None]
    cols = torch.arange(size, device=coord.device)
    return (cols == i0[..., None]) * (1 - frac) + (cols == i1[..., None]) * frac


def crop_resize_boxes(img: torch.Tensor, boxes: torch.Tensor, out_size: int = 32) -> torch.Tensor:
    """img [B, H, W, C]; boxes [B, K, 4] as (x1, y1, x2, y2) -> [B, K, S, S, C]
    in float32 (float64 for a float64 image).

    A degenerate box (x1 == x2 or y1 == y2) must be widened by one pixel
    first, as the trainer's box sampler does."""
    _, h, w, _ = img.shape
    s = out_size
    boxes = boxes.to(device=img.device, dtype=torch.int32)
    x1, y1, x2, y2 = (boxes[..., i, None].float() for i in range(4))  # [B, K, 1]
    grid = torch.arange(s, dtype=torch.float32, device=img.device) + 0.5
    ys = grid * ((y2 - y1) / s) - 0.5 + y1
    xs = grid * ((x2 - x1) / s) - 0.5 + x1
    ys = torch.minimum(torch.maximum(ys, y1), y2 - 1.0).clamp(0.0, h - 1.0)
    xs = torch.minimum(torch.maximum(xs, x1), x2 - 1.0).clamp(0.0, w - 1.0)
    dtype = torch.promote_types(img.dtype, torch.float32)
    rows, cols = (_tap_matrix(c, n).to(dtype) for c, n in ((ys, h), (xs, w)))  # [B, K, S, H | W]
    with no_tf32():
        t = torch.einsum("bkih,bhwc->bkiwc", rows, img.to(dtype))
        return torch.einsum("bkjw,bkiwc->bkijc", cols, t)

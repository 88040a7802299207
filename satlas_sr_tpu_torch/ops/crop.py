"""Differentiable crop-and-resize of OSM object boxes (the JAX package's
`ops/crop.py`).

The reference crops each sampled OSM box out of the GT and the generator's
output and resizes it to 32x32 (ssr/models/osm_objs_esrgan_model.py:163-186).
Boxes come as a [B, K, 4] integer tensor (x1, y1, x2, y2), so the output has
a static shape [B, K, S, S, C]. Sampling is torchvision's tensor resize of
the boxed region: bilinear, half-pixel centres, no antialias, the source
coordinates clamped to the box's interior and then to the image. All boxes
are gathered at once by advanced indexing; the gradient with respect to the
image is autograd's index scatter-add (atomic on the card).
"""

from __future__ import annotations

import torch


def crop_resize_boxes(img: torch.Tensor, boxes: torch.Tensor, out_size: int = 32) -> torch.Tensor:
    """img [B, H, W, C]; boxes [B, K, 4] as (x1, y1, x2, y2) -> [B, K, S, S, C].

    A degenerate box (x1 == x2 or y1 == y2) must be widened by one pixel
    first, as the trainer's box sampler does."""
    b, h, w, _ = img.shape
    s = out_size
    boxes = boxes.to(device=img.device, dtype=torch.int32)
    x1, y1, x2, y2 = (boxes[..., i, None] for i in range(4))  # [B, K, 1]
    bh = (y2 - y1).float()
    bw = (x2 - x1).float()
    grid = torch.arange(s, dtype=torch.float32, device=img.device) + 0.5
    ys = grid * (bh / s) - 0.5 + y1.float()
    xs = grid * (bw / s) - 0.5 + x1.float()
    ys = torch.minimum(torch.maximum(ys, y1.float()), y2.float() - 1.0).clamp(0.0, h - 1.0)
    xs = torch.minimum(torch.maximum(xs, x1.float()), x2.float() - 1.0).clamp(0.0, w - 1.0)
    y0, x0 = ys.floor().long(), xs.floor().long()  # [B, K, S]
    y1i, x1i = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy = (ys - y0)[..., :, None, None]  # [B, K, S, 1, 1]
    wx = (xs - x0)[..., None, :, None]  # [B, K, 1, S, 1]
    bi = torch.arange(b, device=img.device)[:, None, None, None]

    def at(yy, xx):  # [B, K, S, S, C]
        return img[bi, yy[..., :, None], xx[..., None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1i) * wx
    bot = at(y1i, x0) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy

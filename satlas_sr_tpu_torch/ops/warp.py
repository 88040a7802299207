"""Flow warping and modulated deformable convolution (DCNv2), in PyTorch.

Counterpart of satlas_sr_tpu/ops/warp.py (the reference's arch_util.py
flow_warp, resize_flow and DCNv2Pack). The images are NCHW, as everywhere in
the port; a flow is [N, H, W, 2] with (dx, dy) last, as the reference's
flow_warp takes it.

- flow_warp: bilinear (or nearest) sampling at pixel + flow, zeros
  outside: F.grid_sample's result with align_corners=True, computed by the
  same exact gather as deform_conv2d (grid_sample's normalised grid rounds
  the sample points off by an ulp).
- resize_flow: bilinear resize of the flow field (half-pixel centres), its
  values scaled by the size ratios.
- deform_conv2d: DCNv2. Every output position and kernel tap samples x
  bilinearly at p + p_k + offset_k (zeros outside the image), scaled by the
  modulation mask; one contraction over (tap, Cin) with the weights
  follows. A gather of four corners a tap, differentiable end to end: no
  CUDA extension, and no Pallas kernel stands behind it in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .resize import resize_bilinear


def _bilinear_gather(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample img [N, C, H, W] at float coordinates ys, xs [N, *S] ->
    [N, C, *S]; a corner outside the image reads zero."""
    n, c, h, w = img.shape
    flat = img.reshape(n, c, h * w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0).unsqueeze(1), (xs - x0).unsqueeze(1)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        v = torch.gather(flat, 2, idx.reshape(n, 1, -1).expand(n, c, -1))
        return v.reshape(n, c, *ys.shape[1:]) * inside.unsqueeze(1).to(img.dtype)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interp_mode: str = "bilinear",
              align_corners: bool = True) -> torch.Tensor:
    """Warp x [N, C, H, W] by flow [N, H, W, 2] (dx, dy):
    out[n, :, y, x] = x[n, :, y + flow_y, x + flow_x], zeros outside.
    `align_corners` is accepted for the reference's signature: the sample
    points are pixel + flow either way, as in the JAX package."""
    _, _, h, w = x.shape
    gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    ys, xs = gy + flow[..., 1], gx + flow[..., 0]
    if interp_mode == "nearest":
        ys, xs = torch.round(ys), torch.round(xs)
    elif interp_mode != "bilinear":
        raise ValueError(f"interp_mode {interp_mode!r}: bilinear or nearest")
    return _bilinear_gather(x, ys, xs)


def resize_flow(flow: torch.Tensor, size_type: str, sizes: Sequence[float],
                interp_mode: str = "bilinear") -> torch.Tensor:
    """Resize a flow [N, H, W, 2] to a ratio or a shape, its (dx, dy) values
    scaled by the width and height ratios."""
    _, h, w, _ = flow.shape
    if size_type == "ratio":
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == "shape":
        out_h, out_w = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError(f"size_type must be ratio|shape, got {size_type!r}")
    if interp_mode != "bilinear":
        raise ValueError(f"interp_mode {interp_mode!r}: only bilinear is supported")
    scale = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype, device=flow.device)
    return resize_bilinear(flow * scale, (out_h, out_w))


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1) -> torch.Tensor:
    """Modulated deformable conv (DCNv2).

    x [N, Cin, H, W]; offsets [N, 2K, Ho, Wo] as (dy, dx) pairs per kernel
    tap (tap k is channels 2k and 2k + 1, taps row-major); weight
    [Cout, Cin, kh, kw]; mask [N, K, Ho, Wo] (after the sigmoid), optional.
    """
    n, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    k = kh * kw
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    dev = x.device
    base_y = (torch.arange(ho, device=dev) * stride - padding).to(x.dtype)
    base_x = (torch.arange(wo, device=dev) * stride - padding).to(x.dtype)
    tap_y = torch.arange(kh, device=dev).to(x.dtype).repeat_interleave(kw)
    tap_x = torch.arange(kw, device=dev).to(x.dtype).repeat(kh)
    off = offsets.reshape(n, k, 2, ho, wo)
    ys = base_y[None, None, :, None] + tap_y[None, :, None, None] + off[:, :, 0]
    xs = base_x[None, None, None, :] + tap_x[None, :, None, None] + off[:, :, 1]
    sampled = _bilinear_gather(x, ys, xs)  # [N, Cin, K, Ho, Wo]
    if mask is not None:
        sampled = sampled * mask.unsqueeze(1)
    out = torch.einsum("nckhw,ock->nohw", sampled, weight.reshape(cout, cin, k).to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None, None]
    return out

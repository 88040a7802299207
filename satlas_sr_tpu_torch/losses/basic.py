"""Pixel and GAN losses over NHWC tensors (the JAX package's `losses/basic.py`).

- L1Loss / MSELoss with loss_weight and reduction (basicsr basic_loss);
- SSIMLoss: the kornia window-5 SSIM loss map (ops/ssim.py) averaged per
  image, then over the batch, times loss_weight (ssr/losses/basic_loss.py:50-60);
- GANLoss: vanilla BCE-with-logits, lsgan, hinge, wgan, with real/fake
  label values; loss_weight applies to the generator side only, as basicsr's
  GANLoss does (ssr/models/ssr_esrgan_model.py:182,218,224).
`build_loss` turns a YAML `*_opt` block into the closure (CLIPLoss is in
losses/clip.py).

On a rank's row band of the images (the train step on a dp x sp layout)
each mean is the band's: the bands hold equal numbers of values, so the
mean over the space group of the band means is the whole image's mean, and
the trainers' world mean of the logs and gradients takes it
(models/base.py, "Row bands"). SSIMLoss takes the layout (`space`) for the
window's halo rows.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..ops.ssim import ssim_loss as _ssim_loss_map
from ..registry import LOSS_REGISTRY


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


@LOSS_REGISTRY.register("L1Loss")
def l1_loss(loss_weight: float = 1.0, reduction: str = "mean") -> Callable:
    def fn(pred, target):
        return loss_weight * _reduce((pred - target).abs(), reduction)

    return fn


@LOSS_REGISTRY.register("MSELoss")
def mse_loss(loss_weight: float = 1.0, reduction: str = "mean") -> Callable:
    def fn(pred, target):
        return loss_weight * _reduce((pred - target).square(), reduction)

    return fn


@LOSS_REGISTRY.register("SSIMLoss")
def ssim_loss(loss_weight: float = 1.0) -> Callable:
    def fn(pred, target, space=None):
        per_image = _ssim_loss_map(pred, target, window_size=5, space=space).mean(dim=(1, 2, 3))
        return loss_weight * per_image.mean()

    return fn


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy with logits, mean-reduced."""
    loss = logits.clamp(min=0.0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()


@LOSS_REGISTRY.register("GANLoss")
def gan_loss(gan_type: str = "vanilla", real_label_val: float = 1.0,
             fake_label_val: float = 0.0, loss_weight: float = 1.0) -> Callable:
    """fn(logits, target_is_real, is_disc) -> float32 scalar, as basicsr's GANLoss."""
    if gan_type not in ("vanilla", "lsgan", "hinge", "wgan"):
        raise ValueError(f"Unsupported gan_type {gan_type!r}")

    def fn(logits: torch.Tensor, target_is_real: bool, is_disc: bool = False) -> torch.Tensor:
        logits = logits.float()
        label = real_label_val if target_is_real else fake_label_val
        if gan_type == "vanilla":
            loss = bce_with_logits(logits, torch.full_like(logits, label))
        elif gan_type == "lsgan":
            loss = (logits - label).square().mean()
        elif gan_type == "hinge":
            if is_disc:
                loss = (torch.relu(1.0 - logits) if target_is_real
                        else torch.relu(1.0 + logits)).mean()
            else:
                loss = -logits.mean()
        else:  # wgan
            loss = -logits.mean() if target_is_real else logits.mean()
        return loss if is_disc else loss_weight * loss

    return fn


def build_loss(loss_opt: Dict[str, Any]) -> Callable:
    """Instantiate a loss closure from a YAML `*_opt` block (type + kwargs)."""
    opt = dict(loss_opt)
    return LOSS_REGISTRY.get(opt.pop("type"))(**opt)

"""Perceptual (VGG19 feature-matching) loss with an optional style term
(the JAX package's `losses/perceptual.py`).

basicsr's PerceptualLoss as the reference configures it: per-layer weights
on pre-ReLU conv taps, ImageNet input norm, an l1 criterion and an optional
Gram-matrix style weight. The GT's features are computed without gradient
(torch detaches them; the JAX loss stops them). The tower's parameters are
frozen: moved to the prediction's device and cast to `dtype` once.

`fn(pred, gt, space)` on this rank's row bands of an image split over a
space group (the train step on a dp x sp layout): the tower runs on the
bands (losses/vgg.py), the l1 and l2 criteria are the band's means, whose
mean over the group is the whole image's, and the style term's Gram
matrices are summed over the group (parallel/halo.all_reduce_sum) before
the criterion, which every rank then computes whole.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple

import torch

from ..parallel.halo import all_reduce_sum
from ..registry import LOSS_REGISTRY
from .vgg import band_factor, get_vgg19_params, torch_params, vgg19_features


def _criterion(name: str) -> Callable:
    if name == "l1":
        return lambda a, b: (a - b).abs().mean()
    if name in ("l2", "mse"):
        return lambda a, b: (a - b).square().mean()
    if name == "fro":
        return lambda a, b: torch.linalg.vector_norm((a - b).reshape(-1))
    raise ValueError(f"Unsupported perceptual criterion {name!r}")


def _band_criterion(name: str, space) -> Callable:
    """The criterion on a row band's features: l1 and l2 are the band's
    mean (see the module docstring); fro the norm over the whole image,
    from the bands' sums of squares summed over the group."""
    if name == "fro" and space is not None:
        return lambda a, b: torch.sqrt(all_reduce_sum((a - b).square().sum(), space))
    return _criterion(name)


def _gram(feat: torch.Tensor, space=None) -> torch.Tensor:
    """The Gram matrix of the whole image's features; from a row band's
    features, its share summed over the space group."""
    n, c, h, w = feat.shape
    f = feat.reshape(n, c, h * w).float()
    rows = h * (space.space_size if space is not None else 1)
    return all_reduce_sum(torch.einsum("ncp,ndp->ncd", f, f) / (rows * w * c), space)


@LOSS_REGISTRY.register("PerceptualLoss")
def perceptual_loss(layer_weights: Dict[str, float], vgg_type: str = "vgg19",
                    use_input_norm: bool = True, range_norm: bool = False,
                    perceptual_weight: float = 1.0, style_weight: float = 0.0,
                    criterion: str = "l1", vgg_weights_path: Optional[str] = None,
                    dtype: torch.dtype = torch.float32) -> Callable:
    """fn(pred, gt) -> (percep_loss or None, style_loss or None)."""
    if vgg_type != "vgg19":
        raise ValueError(f"only vgg19 towers are wired (the reference's), got {vgg_type!r}")
    params_np, pretrained = get_vgg19_params(vgg_weights_path)
    if not pretrained:
        logging.getLogger("satlas_sr_tpu_torch").warning(
            "PerceptualLoss: no pretrained VGG19 weights found (set SSR_TPU_VGG19_WEIGHTS or "
            "vgg_weights_path); using the seeded random tower: feature matching still "
            "regularises but is not ImageNet-perceptual.")
    taps = list(layer_weights.keys())
    crit = _criterion(criterion)
    placed: Dict[torch.device, Dict] = {}

    def fn(pred: torch.Tensor, gt: torch.Tensor, space=None) -> Tuple[Optional[torch.Tensor],
                                                                      Optional[torch.Tensor]]:
        if pred.device not in placed:
            placed[pred.device] = torch_params(params_np, pred.device, dtype)
        params = placed[pred.device]
        f_pred = vgg19_features(params, pred, taps, use_input_norm, range_norm, dtype, space)
        with torch.no_grad():
            f_gt = vgg19_features(params, gt, taps, use_input_norm, range_norm, dtype, space)
        percep = style = None
        if perceptual_weight > 0:
            band_crit = _band_criterion(criterion, space)
            percep = sum(layer_weights[k] * band_crit(f_pred[k], f_gt[k]) for k in taps) \
                * perceptual_weight
        if style_weight > 0:
            style = sum(layer_weights[k] * crit(_gram(f_pred[k], space), _gram(f_gt[k], space))
                        for k in taps) * style_weight
        return percep, style

    #: what the rows of a band must divide by (vgg.band_factor of the taps)
    fn.band_factor = band_factor(taps)
    return fn

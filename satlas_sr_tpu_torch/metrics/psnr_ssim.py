"""PSNR and SSIM metrics with basicsr-compatible semantics (numpy).

A copy of the JAX package's `metrics/psnr_ssim.py`; it holds no JAX code.

The reference configures `calculate_psnr` / `calculate_ssim` with crop_border=4
and test_y_channel=false (esrgan_s2naip_urban.yml val/test blocks); both are
inherited from basicsr (imported at ssr/metrics/__init__.py:4). Semantics
reproduced:
- inputs are uint8-range HWC numpy images; crop_border strips each side
- PSNR = 10 log10(255^2 / MSE) in float64
- SSIM: per-channel, 11x11 Gaussian window sigma 1.5, valid-region windows
  (the cv2.filter2D + [5:-5, 5:-5] crop), C1/C2 for L=255, mean over channels.
"""

from __future__ import annotations

import numpy as np

from ..registry import METRIC_REGISTRY
from .utils import reorder_image, to_y_channel


@METRIC_REGISTRY.register("calculate_psnr")
def calculate_psnr(
    img, img2, crop_border, input_order="HWC", test_y_channel=False, **kwargs
) -> float:
    assert img.shape == img2.shape, f"shapes differ: {img.shape} vs {img2.shape}"
    img = reorder_image(img, input_order)
    img2 = reorder_image(img2, input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    img = img.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 * 255.0 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    half = size // 2
    x = np.arange(size, dtype=np.float64) - half
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def _ssim_channel(img: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel SSIM on float64 0-255 images, valid-window mean."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    window = _gaussian_window(11, 1.5)

    def filt(a: np.ndarray) -> np.ndarray:
        # valid-region 2D correlation with the 11x11 window
        from numpy.lib.stride_tricks import sliding_window_view

        v = sliding_window_view(a, (11, 11))
        return np.einsum("ijkl,kl->ij", v, window)

    mu1 = filt(img)
    mu2 = filt(img2)
    mu1_sq = mu1**2
    mu2_sq = mu2**2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = filt(img * img) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


@METRIC_REGISTRY.register("calculate_ssim")
def calculate_ssim(
    img, img2, crop_border, input_order="HWC", test_y_channel=False, **kwargs
) -> float:
    assert img.shape == img2.shape, f"shapes differ: {img.shape} vs {img2.shape}"
    img = reorder_image(img, input_order)
    img2 = reorder_image(img2, input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    img = img.astype(np.float64)
    img2 = img2.astype(np.float64)
    ssims = [_ssim_channel(img[..., i], img2[..., i]) for i in range(img.shape[2])]
    return float(np.mean(ssims))

"""Device-batched PSNR/SSIM for validation loops (the JAX package's
`metrics/fast_eval.py` as plain torch functions on the eval device).

Same semantics as calculate_psnr / calculate_ssim (crop_border, 11x11
Gaussian window sigma 1.5, valid-region SSIM windows, L=255) over whole
uint8 NHWC batches, in float32 on the device where the numpy versions run
float64 on the host. The SSIM window is a depthwise valid F.conv2d with
TF32 off, so on the card it is a float32 conv, as on the CPU. Enabled per
config by val.fast_metrics / test.fast_metrics; the numpy implementations
remain the reference.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .psnr_ssim import _gaussian_window


def _crop(img: torch.Tensor, crop_border: int) -> torch.Tensor:
    if crop_border:
        return img[:, crop_border:-crop_border, crop_border:-crop_border]
    return img


@contextlib.contextmanager
def _cudnn_tf32_off():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def batch_psnr(img: torch.Tensor, img2: torch.Tensor, crop_border: int = 0) -> torch.Tensor:
    """uint8 NHWC batches -> [B] float32 PSNR values (basicsr semantics)."""
    a = _crop(img, crop_border).float()
    b = _crop(img2, crop_border).float()
    mse = torch.mean(torch.square(a - b), dim=(1, 2, 3))
    return torch.where(mse == 0, torch.full_like(mse, float("inf")),
                       10.0 * torch.log10(255.0 * 255.0 / mse))


def batch_ssim(img: torch.Tensor, img2: torch.Tensor, crop_border: int = 0) -> torch.Tensor:
    """uint8 NHWC batches -> [B] float32 SSIM values (11x11 Gaussian, valid windows)."""
    a = _crop(img, crop_border).float().permute(0, 3, 1, 2)
    b = _crop(img2, crop_border).float().permute(0, 3, 1, 2)
    c = a.shape[1]
    window = torch.as_tensor(_gaussian_window(11, 1.5), dtype=torch.float32, device=a.device)
    kernel = window.expand(c, 1, 11, 11)

    def filt(x):
        return F.conv2d(x, kernel, groups=c)

    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    with _cudnn_tf32_off():
        mu1, mu2 = filt(a), filt(b)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1 = filt(a * a) - mu1_sq
        sigma2 = filt(b * b) - mu2_sq
        sigma12 = filt(a * b) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2))
    return ssim_map.mean(dim=(1, 2, 3))


FAST_METRICS = {
    "calculate_psnr": batch_psnr,
    "calculate_ssim": batch_ssim,
}


def fast_metric_fn(metric_opt: dict):
    """Return a batched device fn for a metric config, or None if unsupported."""
    if metric_opt.get("test_y_channel"):
        return None
    fn = FAST_METRICS.get(metric_opt.get("type"))
    if fn is None:
        return None
    crop = int(metric_opt.get("crop_border", 0))
    return lambda sr, gt: fn(sr, gt, crop_border=crop)

"""Unsharp-mask sharpening of the ground truth (the JAX package's `ops/usm.py`).

Real-ESRGAN's USM, as the reference applies it to the GT in feed_data
(ssr/models/ssr_esrgan_model.py:31,109): a 51x51 Gaussian blur (OpenCV's
kernel, sigma from the size) with reflect padding, the residual thresholded
at 10/255 into a mask, the mask blurred into a soft mask, and a 0.5-weighted
sharpen blended by it.

Each separable 1-D blur is a dense [n, n] matrix with the reflect padding
folded in (the JAX package's `_blur_matrix`, copied here in numpy), applied
as one float32 matmul per axis with TF32 off: the mask is a threshold of the
blur's residual, so a TF32 blur would flip mask pixels the reference keeps.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_1d(ksize: int) -> np.ndarray:
    """OpenCV getGaussianKernel(ksize, sigma=0): sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    k = k / k.sum()
    return k.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _blur_matrix(ksize: int, n: int) -> np.ndarray:
    """Dense [n, n] matrix applying the 1-D Gaussian with reflect padding.

    out[i] = sum_t k[t] * x[reflect(i + t - pad)], np.pad 'reflect' (OpenCV
    BORDER_REFLECT_101: no edge repeat); pads wider than the input fold
    repeatedly (period 2(n-1)), as np.pad does.
    """
    k = _gaussian_kernel_1d(ksize).astype(np.float64)
    pad = (ksize - 1) // 2
    m = np.zeros((n, n), dtype=np.float64)
    period = 2 * (n - 1) if n > 1 else 1
    for i in range(n):
        for t in range(ksize):
            p = abs(i + t - pad) % period if n > 1 else 0
            if p >= n:
                p = period - p
            m[i, p] += k[t]
    return m.astype(np.float32)


@contextlib.contextmanager
def no_tf32():
    """cuBLAS float32 matmuls in full float32 (TF32 off) while active."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _blur_separable(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable Gaussian blur of NHWC with reflect padding, via two matmuls."""
    x = img.float()
    _, h, w, _ = x.shape
    mh = torch.from_numpy(_blur_matrix(ksize, h)).to(x.device)
    mw = torch.from_numpy(_blur_matrix(ksize, w)).to(x.device)
    with no_tf32():
        x = torch.einsum("ij,njwc->niwc", mh, x)
        x = torch.einsum("ij,nhjc->nhic", mw, x)
    return x.to(img.dtype)


def usm_sharp(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
              threshold: float = 10.0) -> torch.Tensor:
    """Unsharp-mask sharpen an NHWC float image in [0, 1].

    radius is rounded up to odd (OpenCV's convention); the residual mask is
    thresholded on the 0-255 scale, then blurred into a soft mask.
    """
    ksize = radius + 1 if radius % 2 == 0 else radius
    blur = _blur_separable(img, ksize)
    residual = img - blur
    mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
    soft_mask = _blur_separable(mask, ksize)
    sharp = (img + weight * residual).clamp(0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * img

"""Differentiable SSIM, the training-loss flavour, on NHWC tensors (the JAX
package's `ops/ssim.py`).

kornia's ssim_loss as the L2 trainer's WorldStrat loss and SSIMLoss use it:
a 5-tap Gaussian window with sigma 1.5, reflect padding, C1 = (0.01 max)^2,
C2 = (0.03 max)^2 and the loss map (1 - ssim) / 2. Inputs are cast to
float32 first, so a bfloat16 step still computes the loss in float32.

The separable filter is written as shifted products and sums, summed as
((t0 + t1) + (t2 + t3)) + t4: elementwise float32 arithmetic that no
`allow_tf32` setting reaches, so the port's default `matmul_precision`
cannot bring back the failure the JAX package pins HIGHEST against (a TF32
or bf16 filter errs in E[x^2] by more than C2 = 9e-4, the denominator
crosses zero and the map turns inf, then NaN). Each product and sum rounds
once, on the card as on the CPU, in the order XLA's CPU convolution sums
the window, so the map equals the JAX package's on the CPU bit for bit.
The variances are clamped at 0, as there (sigma_xy, a covariance, is not).

With `space` (the train step on a dp x sp layout) the inputs are a rank's
row bands: the window's halo of window//2 rows comes from the neighbour
bands (parallel/halo.pad_rows) and only the image's true border is
reflected, so the band's rows of the map are the whole image's.

The metric-flavour SSIM (11x11 window, uint8 numpy) is metrics/psnr_ssim.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel.halo import pad_rows


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> tuple:
    half = window_size // 2
    x = np.arange(window_size, dtype=np.float64) - half
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source rows of a reflect-padded axis of length n (no edge repeat)."""
    idx = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


def _window_sum(x: torch.Tensor, k1d: tuple, dim: int, n: int) -> torch.Tensor:
    """sum_t k[t] * x[t : t + n] along `dim`, summed ((t0+t1)+(t2+t3))+t4 for
    five taps (pairwise in order for any count)."""
    terms = [x.narrow(dim, t, n) * w for t, w in enumerate(k1d)]
    while len(terms) > 1:
        pairs = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        terms = pairs + ([terms[-1]] if len(terms) % 2 else [])
    return terms[0]


def filter_separable_reflect(x: torch.Tensor, k1d: tuple, space=None) -> torch.Tensor:
    """Same-size separable filtering of NHWC x with reflect padding, per
    channel. With `space` x is this rank's row band: its halo rows come from
    the neighbour bands, and only the image's own border is reflected."""
    pad = len(k1d) // 2
    _, h, w, _ = x.shape
    if space is None:
        xr = x.index_select(1, _reflect_index(h, pad, x.device))
    else:
        if h <= pad:
            raise ValueError(f"an SSIM band of {h} rows cannot reflect a window of "
                             f"{len(k1d)} rows: it needs more than {pad}")
        xr = pad_rows(x, pad, pad, space, dim=1, border="reflect")
    xr = xr.index_select(2, _reflect_index(w, pad, x.device))
    return _window_sum(_window_sum(xr, k1d, 1, h), k1d, 2, w)


def ssim_map(x: torch.Tensor, y: torch.Tensor, window_size: int = 5, max_val: float = 1.0,
             sigma: float = 1.5, space=None) -> torch.Tensor:
    """Per-pixel SSIM map of two NHWC images (the inputs' shape, float32);
    with `space`, of this rank's row bands, the band's rows of the map."""
    k1d = _gaussian_1d(window_size, sigma)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    xf, yf = x.float(), y.float()
    c = xf.shape[-1]
    # the five moments through one filter pass, stacked on the channel axis
    moments = filter_separable_reflect(torch.cat([xf, yf, xf * xf, yf * yf, xf * yf], -1), k1d,
                                       space)
    mu_x, mu_y, e_xx, e_yy, e_xy = moments.split(c, dim=-1)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    zero = torch.zeros((), dtype=xf.dtype, device=xf.device)
    sigma_x = torch.maximum(e_xx - mu_xx, zero)  # at a tie both take half the gradient, as in JAX
    sigma_y = torch.maximum(e_yy - mu_yy, zero)
    sigma_xy = e_xy - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return num / den


def ssim_loss(x: torch.Tensor, y: torch.Tensor, window_size: int = 5,
              max_val: float = 1.0, space=None) -> torch.Tensor:
    """kornia's SSIM loss map, (1 - ssim) / 2, in the inputs' shape."""
    return (1.0 - ssim_map(x, y, window_size=window_size, max_val=max_val, space=space)) / 2.0

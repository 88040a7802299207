"""cPSNR (PROBA-V) metric: translation + per-channel-bias tolerant PSNR (numpy).

A copy of the JAX package's `metrics/cpsnr.py`; it holds no JAX code.

Parity with ssr/metrics/cpsnr.py:8-59: search all (row, col) offsets up to
max_offset=8 between the two crop-bordered images, correct per-channel mean
bias, take the minimum MSE, return 10 log10(255^2 / mse).
"""

from __future__ import annotations

import numpy as np

from ..registry import METRIC_REGISTRY
from .utils import reorder_image, to_y_channel


@METRIC_REGISTRY.register("calculate_cpsnr")
def calculate_cpsnr(
    img,
    img2,
    crop_border,
    input_order="HWC",
    test_y_channel=False,
    max_offset: int = 8,
    **kwargs,
) -> float:
    assert img.shape == img2.shape, f"shapes differ: {img.shape} vs {img2.shape}"
    img1 = reorder_image(img, input_order)
    img2 = reorder_image(img2, input_order)
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img1 = to_y_channel(img1)
        img2 = to_y_channel(img2)
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)

    height, width = img1.shape[0], img1.shape[1]
    crop_h, crop_w = height - max_offset, width - max_offset
    best_mse = None
    for ro in range(max_offset + 1):
        for co in range(max_offset + 1):
            a = img1[ro : ro + crop_h, co : co + crop_w]
            b = img2[max_offset - ro : max_offset - ro + crop_h,
                     max_offset - co : max_offset - co + crop_w]
            bias = (a - b).mean(axis=(0, 1), keepdims=True)
            mse = np.mean(np.square(a - (b + bias)))
            if best_mse is None or mse < best_mse:
                best_mse = mse
    if best_mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 * 255.0 / best_mse))

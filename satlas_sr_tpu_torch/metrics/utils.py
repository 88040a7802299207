"""Metric image helpers (numpy, uint8 HWC convention).

The JAX package's `metrics/utils.py`, copied: reorder_image, to_y_channel and
the BT.601 bgr2ycbcr used by the y-channel metric options.
"""

from __future__ import annotations

import numpy as np


def reorder_image(img: np.ndarray, input_order: str = "HWC") -> np.ndarray:
    if input_order not in ("HWC", "CHW"):
        raise ValueError(f"Wrong input_order {input_order!r}; expected 'HWC' or 'CHW'")
    if len(img.shape) == 2:
        return img[..., None]
    if input_order == "CHW":
        return img.transpose(1, 2, 0)
    return img


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """BT.601 limited-range conversion on float images in [0, 1] (BGR order)."""
    if y_only:
        out = np.dot(img, [24.966, 128.553, 65.481]) + 16.0
    else:
        out = np.matmul(
            img,
            [
                [24.966, 112.0, -18.214],
                [128.553, -74.203, -93.786],
                [65.481, -37.797, 112.0],
            ],
        ) + [16, 128, 128]
    return out / 255.0


def rgb2ycbcr_y(img: np.ndarray) -> np.ndarray:
    """BT.601 limited-range luma for RGB-ordered float images in [0, 1]."""
    return (np.dot(img, [65.481, 128.553, 24.966]) + 16.0) / 255.0


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """Luma extraction for the y-channel metric options.

    This framework is RGB end-to-end (utils/imgio.py), unlike the reference's
    cv2/BGR convention — so the RGB coefficient order is used; applying the
    reference's bgr2ycbcr verbatim here would swap the R and B luma weights.
    """
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = rgb2ycbcr_y(img)
        img = img[..., None]
    return img * 255.0

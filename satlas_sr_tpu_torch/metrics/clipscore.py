"""CLIPScore: cosine similarity of image-tower embeddings (the JAX package's
`metrics/clipscore.py`; ssr/metrics/clipscore.py:8-38, the shipped configs
name siglip-ViT-SO400M-14).

Both images are resized, nearest (F.interpolate's default mode, as the
reference), to the tower's input size, encoded in one batch, L2-normalised
with + 1e-8 and dotted; no mean/std normalisation, as the reference. The
tower is built once per process (metrics/clip_encoder.py: local weights via
`clip_weights_path` or SSR_TPU_CLIP_WEIGHTS, else the seeded random tower)
and runs in float32 on the device the caller names (validation passes the
model's).
"""

from __future__ import annotations

import functools
import logging
from typing import Callable

import numpy as np
import torch

from ..ops.resize import resize_nearest
from ..registry import METRIC_REGISTRY
from .clip_encoder import MODEL_SPECS, device_key, get_encoder, is_pretrained


@functools.lru_cache(maxsize=4)
def _scorer(clip_model: str, weights_path, device: str) -> Callable:
    tower, pretrained = get_encoder(clip_model, weights_path, device)
    if not pretrained:
        logging.getLogger("satlas_sr_tpu_torch").warning(
            "CLIPScore: no local weights for %s; scores use a seeded random tower.", clip_model)
    size = MODEL_SPECS[clip_model].image_size

    def score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] pairs in [0, 1] -> [N] cosine similarities."""
        f = tower(resize_nearest(torch.cat([a, b]), (size, size)))
        f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-8)
        fa, fb = f.chunk(2)
        return (fa * fb).sum(dim=-1)

    return score


def tower_pretrained(clip_model, clip_weights_path=None, **kwargs) -> bool:
    """True iff this metric's tower has real (non-random) weights loaded."""
    return clip_model in MODEL_SPECS and is_pretrained(clip_model, clip_weights_path)


@METRIC_REGISTRY.register("calculate_clipscore")
def calculate_clipscore(img, img2, clip_model, clip_weights_path=None, device="cuda",
                        **kwargs) -> float:
    """uint8 HWC images -> CLIPScore (higher better), computed on `device`."""
    if clip_model not in MODEL_SPECS:
        raise ValueError(f"{clip_model} is not supported for CLIPScore.")
    dev = device_key(device)
    score = _scorer(clip_model, clip_weights_path, dev)
    a = torch.from_numpy(np.asarray(img)).to(dev).float()[None] / 255.0
    b = torch.from_numpy(np.asarray(img2)).to(dev).float()[None] / 255.0
    with torch.no_grad():
        return float(score(a, b)[0])

"""CLIP-embedding similarity loss (the JAX package's `losses/clip.py`;
ssr/losses/basic_loss.py:20-48): L1 between the image-tower embeddings of
the output and of the GT, after a nearest resize to the tower's input size
and the OpenAI mean/std normalisation.

The tower (metrics/clip_encoder.py) comes from `clip_weights_path` or
SSR_TPU_CLIP_WEIGHTS, else it is the seeded random tower, with a warning.
It is frozen and placed on the prediction's device at the first call. It
computes in float32 whatever the trainer's compute dtype: a bfloat16 output
is promoted by the normalisation, as in the JAX loss, whose tower closes
over float32 params. The gradient reaches the prediction only: the GT's
embedding is computed under no_grad (the JAX loss stops it).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from ..metrics.clip_encoder import MODEL_SPECS, get_encoder, is_pretrained
from ..ops.resize import resize_nearest
from ..registry import LOSS_REGISTRY

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


@LOSS_REGISTRY.register("CLIPLoss")
def clip_loss(clip_loss_model: str = "ViT-B-16-SigLIP-256", loss_weight: float = 1.0,
              clip_weights_path: Optional[str] = None) -> Callable:
    """fn(x, gt): NHWC in [0, 1] -> loss_weight * mean |f(x) - f(gt)|."""
    size = MODEL_SPECS[clip_loss_model].image_size
    if not is_pretrained(clip_loss_model, clip_weights_path):
        logging.getLogger("satlas_sr_tpu_torch").warning(
            "CLIPLoss: no local weights for %s; using a seeded random tower.", clip_loss_model)

    stats = {}  # device -> (mean, std)

    def normalise(img: torch.Tensor) -> torch.Tensor:
        img = resize_nearest(img, (size, size)).float()
        if img.device not in stats:
            stats[img.device] = (torch.tensor(OPENAI_DATASET_MEAN, device=img.device),
                                 torch.tensor(OPENAI_DATASET_STD, device=img.device))
        mean, std = stats[img.device]
        return (img - mean) / std

    def fn(x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        tower, _ = get_encoder(clip_loss_model, clip_weights_path, x.device)
        fx = tower(normalise(x))
        with torch.no_grad():
            fgt = tower(normalise(gt))
        return loss_weight * (fx - fgt).abs().mean()

    return fn

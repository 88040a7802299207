"""HighResNet: SRCNN with recursive pairwise revisit fusion.

Counterpart of satlas_sr_tpu/archs/highresnet.py: SRCNN's encoder and
super-resolver around a RecursiveFusion of log2(T) pairwise FusionBlock
applications that share ONE set of weights (the reference's quirk, kept).
A mask channel does not fit that fusion (its FusionBlock takes
hidden_channels per revisit), so mask_channels must be 0.
"""

from __future__ import annotations

import torch

from .blocks import RecursiveFusion
from .srcnn import SRCNN


class HighResNet(SRCNN):
    def __init__(self, *args, mask_channels: int = 0, **kwargs):
        if mask_channels:
            raise ValueError("HighResNet takes no mask (mask_channels must be 0)")
        super().__init__(*args, mask_channels=0, **kwargs)

    def _build_fusion(self, hidden: int, kernel_size: int, residual_layers: int, enc_channels: int):
        self.fusion = RecursiveFusion(hidden, kernel_size)

    def _fuse(self, enc: torch.Tensor, space=None) -> torch.Tensor:
        return self._run(self.fusion, enc, space)

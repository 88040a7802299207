"""SRCNN (the WorldStrat baseline): revisits fused as channels.

Counterpart of satlas_sr_tpu/archs/srcnn.py: a per-revisit DoubleConv2d
encoder, channel-concat fusion (DoubleConv2d and `residual_layers`
ResidualBlocks), a PixelShuffle super-resolver and a bilinear, antialiased
resize to `output_size`. `use_reference_frame` concatenates the lower median
over the revisits to every revisit; `mask_channels` > 0 adds the OneHot(12)
mask encoder, whose one channel per revisit joins the fusion (a mask must
then be passed).

`forward` takes [B, T, H, W, C] (T = `revisits`) and returns
[B, 1, H', W', C'], NHWC like the JAX model; the blocks run NCHW inside.
Module names are the reference .pth names. Parameters are made on the CPU
from a torch.Generator seeded by `seed` (blocks.init_weights), then moved
to `device`. In train mode the DoubleConv2d dropouts draw from the
`DropoutMasks` given to `set_dropout_masks` (the L2 trainer's).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.median import lower_median
from ..ops.resize import resize_bilinear
from .blocks import (DoubleConv2d, Dropout, DropoutMasks, OneHot, PixelShuffleBlock,
                     ResidualBlock, init_weights)


class SRCNN(nn.Module):
    def __init__(self, in_channels: int = 3, mask_channels: int = 0, revisits: int = 8,
                 hidden_channels: int = 128, out_channels: int = 3, kernel_size: int = 3,
                 residual_layers: int = 1, output_size: Union[int, tuple] = 128,
                 zoom_factor: int = 4, sr_kernel_size: int = 1, use_reference_frame: bool = False,
                 dtype: torch.dtype = torch.float32, seed: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.revisits = revisits
        self.use_reference_frame = use_reference_frame
        self.output_size = ((output_size, output_size) if isinstance(output_size, int)
                            else tuple(output_size))
        #: compute dtype the inference engine runs the model in
        self.dtype = dtype
        enc_in = in_channels * (2 if use_reference_frame else 1)
        self.encoder = DoubleConv2d(enc_in, hidden_channels, kernel_size)
        self.mask_channels = mask_channels
        if mask_channels > 0:
            self.mask_encoder = nn.Sequential(OneHot(12), DoubleConv2d(12, 1, 3), nn.Sigmoid())
        self._build_fusion(hidden_channels, kernel_size, residual_layers,
                           hidden_channels + (1 if mask_channels > 0 else 0))
        self.sr = PixelShuffleBlock(hidden_channels, out_channels, sr_kernel_size, zoom_factor)
        self.to_empty(device="cpu")
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def set_dropout_masks(self, masks: DropoutMasks) -> None:
        """Every dropout layer takes its keep masks from `masks`."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.masks = masks

    def _build_fusion(self, hidden: int, kernel_size: int, residual_layers: int, enc_channels: int):
        self.doubleconv2d = DoubleConv2d(self.revisits * enc_channels, hidden, kernel_size)
        self.residualblocks = nn.Sequential(*(ResidualBlock(hidden, kernel_size)
                                              for _ in range(residual_layers)))

    def _fuse(self, enc: torch.Tensor) -> torch.Tensor:
        """[B, T, C, H, W] -> [B, hidden, H, W]: revisit-major channels."""
        b, t, c, h, w = enc.shape
        return self.residualblocks(self.doubleconv2d(enc.reshape(b, t * c, h, w)))

    def _encode(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """[B, T, H, W, C] -> [B, T, hidden (+1 with a mask), H, W]."""
        x = x.permute(0, 1, 4, 2, 3)
        if self.use_reference_frame:
            x = torch.cat([x, lower_median(x, dim=1, keepdim=True).expand_as(x)], dim=2)
        b, t, c, h, w = x.shape
        enc = self.encoder(x.reshape(b * t, c, h, w))
        if self.mask_channels > 0:
            if mask is None:
                raise ValueError("this SRCNN was built with mask_channels > 0: pass a mask")
            m = self.mask_encoder(mask.reshape(b * t, h, w, -1).permute(0, 3, 1, 2))
            enc = torch.cat([enc, m.to(enc.dtype)], dim=1)
        return enc.reshape(b, t, -1, h, w)

    def _super_resolve(self, fused: torch.Tensor) -> torch.Tensor:
        y = self.sr(fused).permute(0, 2, 3, 1)
        return resize_bilinear(y, self.output_size, antialias=True)[:, None]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._super_resolve(self._fuse(self._encode(x, mask)))

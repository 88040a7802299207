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

`forward_band(x_band, space)` is the forward of one rank's row band
[B, T, h, W, C] of an image split over a space group (parallel/mesh.mesh_2d):
the same modules, each block through its row-band forward
(blocks.band_call: halo rows from the neighbour bands, reflected on the
image's borders), and the resize through ops/resize.resize_bilinear_band.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.median import lower_median
from ..ops.resize import resize_bilinear, resize_bilinear_band
from .blocks import (DoubleConv2d, Dropout, DropoutMasks, OneHot, PixelShuffleBlock,
                     ResidualBlock, band_call, init_weights)


class SRCNN(nn.Module):
    def __init__(self, in_channels: int = 3, mask_channels: int = 0, revisits: int = 8,
                 hidden_channels: int = 128, out_channels: int = 3, kernel_size: int = 3,
                 residual_layers: int = 1, output_size: Union[int, tuple] = 128,
                 zoom_factor: int = 4, sr_kernel_size: int = 1, use_reference_frame: bool = False,
                 dtype: torch.dtype = torch.float32, seed: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.revisits = revisits
        #: (factor, least) of a row band's input rows: no factor; enough rows
        #: for one conv's halo and for reflecting on the border
        self.band_rows = (1, max(kernel_size, 3) // 2 + 1)
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

    @staticmethod
    def _run(module: nn.Module, x: torch.Tensor, space) -> torch.Tensor:
        """module(x), or on a row band of `space` (blocks.band_call)."""
        return module(x) if space is None else band_call(module, x, space)

    def _fuse(self, enc: torch.Tensor, space=None) -> torch.Tensor:
        """[B, T, C, H, W] -> [B, hidden, H, W]: revisit-major channels."""
        b, t, c, h, w = enc.shape
        fused = self._run(self.doubleconv2d, enc.reshape(b, t * c, h, w), space)
        return self._run(self.residualblocks, fused, space)

    def _encode(self, x: torch.Tensor, mask: Optional[torch.Tensor], space=None) -> torch.Tensor:
        """[B, T, H, W, C] -> [B, T, hidden (+1 with a mask), H, W]."""
        x = x.permute(0, 1, 4, 2, 3)
        if self.use_reference_frame:
            x = torch.cat([x, lower_median(x, dim=1, keepdim=True).expand_as(x)], dim=2)
        b, t, c, h, w = x.shape
        enc = self._run(self.encoder, x.reshape(b * t, c, h, w), space)
        if self.mask_channels > 0:
            if mask is None:
                raise ValueError("this SRCNN was built with mask_channels > 0: pass a mask")
            m = self._run(self.mask_encoder, mask.reshape(b * t, h, w, -1).permute(0, 3, 1, 2),
                          space)
            enc = torch.cat([enc, m.to(enc.dtype)], dim=1)
        return enc.reshape(b, t, -1, h, w)

    def _super_resolve(self, fused: torch.Tensor, space=None) -> torch.Tensor:
        y = self._run(self.sr, fused, space).permute(0, 2, 3, 1)
        if space is None:
            return resize_bilinear(y, self.output_size, antialias=True)[:, None]
        return resize_bilinear_band(y, self.output_size, space, antialias=True)[:, None]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._super_resolve(self._fuse(self._encode(x, mask)))

    def forward_band(self, x: torch.Tensor, space,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`forward` of this rank's row band x [B, T, h, W, C] (and mask) of
        an image split over `space`: its band of the output [B, 1, h', W', C']."""
        return self._super_resolve(self._fuse(self._encode(x, mask, space), space), space)

"""Spectral normalisation of a conv kernel (the JAX package's `ops/spectral_norm.py`).

The reference wraps its discriminator convs in torch's spectral_norm
(ssr/archs/discriminator_arch.py:26-39); the JAX package threads the
power-iteration vectors through its train step as a `spectral` collection.
Here they are module buffers with the reference's names: `weight_orig` is
the OIHW kernel, `weight_u` [O] and `weight_v` [I*kh*kw] the vectors, so a
reference discriminator .pth loads with load_state_dict.

One power iteration per forward under `update_stats=True`, on the detached
kernel, writing the buffers; sigma = u^T W v with u and v held constant, so
the gradient flows only through W. Layout NHWC in and out, like the JAX
module. `forward_band` runs the conv on a row band (the 'space' layout of
the train step).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.halo import conv2d_band


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class SNConv(nn.Module):
    """2D conv with a spectrally normalised kernel, NHWC."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = True, n_power_iterations: int = 1,
                 generator: torch.Generator = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.n_power_iterations = n_power_iterations
        bound = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)  # the JAX init's
        w = torch.empty(out_ch, in_ch, kernel_size, kernel_size).uniform_(
            -bound, bound, generator=generator)
        self.weight_orig = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.register_buffer("weight_u", _l2_normalize(torch.randn(out_ch, generator=generator)))
        self.register_buffer("weight_v", _l2_normalize(
            torch.randn(in_ch * kernel_size * kernel_size, generator=generator)))

    def normalized_weight(self, update_stats: bool = False) -> torch.Tensor:
        """weight_orig / sigma (float32), after one power iteration with
        update_stats."""
        w_mat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        if update_stats:
            with torch.no_grad():
                w_ng = w_mat.detach()
                u = self.weight_u
                for _ in range(self.n_power_iterations):
                    v = _l2_normalize(w_ng.t() @ u)
                    u = _l2_normalize(w_ng @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        else:
            u, v = self.weight_u.clone(), self.weight_v.clone()
        sigma = torch.dot(u, w_mat @ v)
        return self.weight_orig / sigma

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w_bar = self.normalized_weight(update_stats).to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w_bar,
                     None if self.bias is None else self.bias.to(x.dtype),
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)

    def forward_band(self, x: torch.Tensor, space, update_stats: bool = False) -> torch.Tensor:
        """`forward` of this rank's row band of an image split over `space`
        (parallel/halo.conv2d_band). The power iteration runs on the whole
        weight, replicated on every rank, so u and v stay equal on all."""
        w_bar = self.normalized_weight(update_stats).to(x.dtype)
        y = conv2d_band(x.permute(0, 3, 1, 2), w_bar,
                        None if self.bias is None else self.bias.to(x.dtype), space,
                        stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)

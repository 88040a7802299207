"""GAN regularizers (the JAX package's `losses/regularizers.py`; the basicsr
re-exports at ssr/losses/__init__.py:7,11): r1_penalty,
gradient_penalty_loss and g_path_regularize.

No shipped config enables them; they are part of the exported loss surface.
Each takes a gradient with `torch.autograd.grad(..., create_graph=True)`,
so the penalty itself is differentiable with respect to the network's
weights. The random draws (the interpolation weights, the path noise) are
passed in as tensors or drawn from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch


def _input_grad(out: torch.Tensor, x: torch.Tensor, grad_out=None) -> torch.Tensor:
    (g,) = torch.autograd.grad(out if grad_out is not None else out.sum(), x,
                               grad_outputs=grad_out, create_graph=True)
    return g


def _differentiable(x: torch.Tensor) -> torch.Tensor:
    return x if x.requires_grad else x.detach().requires_grad_()


def r1_penalty(disc_fn: Callable, real: torch.Tensor) -> torch.Tensor:
    """R1: E[ ||grad_x D(x)||^2 ] on real images (StyleGAN2's lazy-R1 form)."""
    real = _differentiable(real)
    grads = _input_grad(disc_fn(real), real)
    return grads.reshape(real.shape[0], -1).square().sum(dim=1).mean()


def gradient_penalty_loss(disc_fn: Callable, real: torch.Tensor, fake: torch.Tensor,
                          alpha: Optional[torch.Tensor] = None,
                          weight: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """WGAN-GP: (||grad D(x_interp)|| - 1)^2 on real/fake interpolations.

    `alpha` [B, 1, ..., 1] is the interpolation weight of the real image;
    when None it is drawn uniform in [0, 1) from `generator`."""
    if alpha is None:
        alpha = torch.rand((real.shape[0],) + (1,) * (real.dim() - 1), generator=generator,
                           device=real.device)
    interp = _differentiable(real * alpha + fake * (1.0 - alpha))
    grads = _input_grad(disc_fn(interp), interp)
    if weight is not None:
        grads = grads * weight
    norms = torch.sqrt(grads.reshape(real.shape[0], -1).square().sum(dim=1) + 1e-12)
    loss = (norms - 1.0).square().mean()
    if weight is not None:
        loss = loss / weight.mean()
    return loss


def g_path_regularize(gen_fn: Callable, latents: torch.Tensor, mean_path_length: torch.Tensor,
                      decay: float = 0.01, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """StyleGAN2's path-length regularizer on an NHWC generator.

    The path length is ||J^T n|| per sample, a vector-Jacobian product with
    n = noise / sqrt(H * W); `noise` is a standard normal draw of the
    output's shape (drawn from `generator` when None). Returns (penalty,
    detached path lengths, detached updated mean path length)."""
    latents = _differentiable(latents)
    fake = gen_fn(latents)
    if noise is None:
        noise = torch.randn(fake.shape, generator=generator, device=fake.device)
    scaled = noise.to(fake.dtype) / math.sqrt(fake.shape[1] * fake.shape[2])
    grads = _input_grad(fake, latents, scaled)
    path_lengths = torch.sqrt(grads.reshape(latents.shape[0], -1).square().sum(dim=1) + 1e-12)
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    penalty = (path_lengths - path_mean).square().mean()
    return penalty, path_lengths.detach(), path_mean.detach()

"""flax's default conv kernel init, for the port's generators and
discriminators: `lecun_normal_`.

flax's nn.Conv draws its kernel from lecun_normal, variance_scaling(1,
'fan_in', 'truncated_normal'): a standard normal truncated to [-2, 2],
scaled by sqrt(1 / fan_in) / 0.8796..., the standard deviation of that
truncated normal, so the weights have variance 1 / fan_in and no weight
exceeds 2.27 times their standard deviation.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

#: the standard deviation of a standard normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill an OIHW conv weight (fan_in = I x H x W) in place, as flax's
    default kernel init draws it."""
    std = math.sqrt(1.0 / weight[0].numel()) / TRUNCATED_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

"""Lower median over an axis: for an even count, the lower of the two middle
elements (torch.median's rule, unlike numpy's mean of the two). SRCNN's
reference frame is this median over the revisits."""

from __future__ import annotations

import torch


def lower_median(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    med = torch.sort(x, dim=dim).values.narrow(dim, (x.shape[dim] - 1) // 2, 1)
    return med if keepdim else med.squeeze(dim)

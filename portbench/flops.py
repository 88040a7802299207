"""Operations and bytes of the cells' work, from shapes and from the plain
reference.

- `rdb_*`: one dense block at [B, H, W, nf] with growth g: five 3x3 convs,
  conv k reading nf + (k - 1) g channels and writing g (nf for the last),
  239,616 multiply-adds a pixel at nf 64, g 32. Its bytes are x read once,
  the output written once and the weights and biases read once.
- `count`: FLOPs of a function by torch.utils.flop_counter, run on meta
  tensors, so nothing is computed and any device gives the same count.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def rdb_macs_per_pixel(nf: int, g: int) -> int:
    return 9 * sum((nf + k * g) * (g if k < 4 else nf) for k in range(5))


def rdb_flops(b: int, h: int, w: int, nf: int, g: int) -> int:
    return 2 * b * h * w * rdb_macs_per_pixel(nf, g)


def rdb_bytes(b: int, h: int, w: int, nf: int, g: int, itemsize: int) -> int:
    weights = rdb_macs_per_pixel(nf, g) + 4 * g + nf
    return (2 * b * h * w * nf + weights) * itemsize


def roofline_s(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def count(fn: Callable[[], object]) -> int:
    """Total FLOPs flop_counter counts while `fn` runs."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def rrdbnet_flops_per_image(net: Dict, hw: int = 32) -> int:
    """FLOPs of one image through the reference generator."""
    from . import weights
    from .reference import nets

    sd = weights.on_meta(weights.rrdbnet_specs(net))
    x = torch.empty(1, hw, hw, int(net["num_in_ch"]), device="meta")
    return count(lambda: nets.rrdbnet(sd, x, int(net["num_block"])))


"""Lower-precision convolutions for the controls of `correct`.

A control is the reference put in the program's place and computed in the
nearest precision below the one the configuration states: TF32 below
float32 with TF32 off, fp8 below bfloat16. Both are emulated by rounding
the operands of a convolution, which is what the tensor cores do with
them, and accumulating in float32. The rounding is
bitwise, so it reads the same on the CPU and the card.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) with its mantissa rounded to TF32's 10 bits, ties away
    from zero (the tensor cores' cvt.rna)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 (e4m3) under a per-tensor scale that maps its
    largest magnitude onto the format's largest value, as fp8 inference
    scales a tensor; returned in float32."""
    x = x.float()
    amax = x.abs().max()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def rounded_conv(rnd: Callable) -> Callable:
    """F.conv2d with both operands rounded by `rnd`, accumulated in float32."""

    def conv(x, w, b=None, stride=1, padding=0):
        return F.conv2d(rnd(x.float()), rnd(w.float()), None if b is None else b.float(),
                        stride=stride, padding=padding)

    return conv


#: the control's convolution for each precision a configuration can state
CONTROLS = {
    "float32": rounded_conv(round_tf32),
    "bfloat16": rounded_conv(round_fp8),
}

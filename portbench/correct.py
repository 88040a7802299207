"""The numbers that decide `correct`, and the judgement against a cell's limits.

`image_numbers`: the program's uint8 images against the reference's, quantised as the program quantises (clamp to [0, 1], x255,
truncation). Per image: the share of values that differ at all, the share
that differ by two levels or more (a value next to a truncation step flips
by one level under any rounding), and the root mean square difference in
levels; the numbers are the worst image's, so one altered image shows
whole.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def quantize(y: torch.Tensor) -> torch.Tensor:
    """Float image -> uint8 as the infer CLI writes it: clamp, x255, truncate."""
    return (y.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def image_numbers(program: torch.Tensor, reference_u8: torch.Tensor) -> Dict[str, float]:
    """program, reference_u8: uint8 [N, H, W, C] on one device."""
    if program.shape != reference_u8.shape:
        return {"worst_off_pct": 100.0, "worst_far_pct": 100.0, "worst_rmse_levels": 255.0}
    d = (program.float() - reference_u8.float()).flatten(1)
    off = (d != 0).float().mean(1) * 100.0
    far = (d.abs() >= 2).float().mean(1) * 100.0
    rmse = d.square().mean(1).sqrt()
    return {"worst_off_pct": float(off.max()), "worst_far_pct": float(far.max()),
            "worst_rmse_levels": float(rmse.max())}


def worst(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: max(a.get(k, float("-inf")), b.get(k, float("-inf"))) for k in {**a, **b}}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {name: {"value", "limit"}}) over the numbers a cell compares.
    A number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def check_lines(checks: Dict[str, Dict]) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]

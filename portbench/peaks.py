"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheets,
SXM parts, dense rates without sparsity, at the full power limit).

A cell's compute peak is the rate of the least tensor-core route that can
compute its stated precision: bfloat16 at the bf16 rate, float32 at the
TF32 rate (a float32 product computed as several TF32 products, as the
port's kernel does, can only read lower against it)."""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12, "float32": 495e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(device_kind: str, key: str) -> Optional[float]:
    """The card's peak `key` (a dtype's FLOP/s, or hbm_bytes_per_s); None
    for a card the table does not hold, whose shares are then left out."""
    return PEAKS.get(device_kind, {}).get(key)

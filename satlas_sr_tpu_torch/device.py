"""Device selection for the port's entry points: CUDA unless the caller asks
for the CPU, and never a silent fallback from one to the other.

A bare "cuda" is the rank's card, cuda:LOCAL_RANK (0 when unset), as
torchrun numbers the processes of a host; a LOCAL_RANK beyond the host's
cards raises instead of wrapping or falling back to the CPU."""

from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises RuntimeError when CUDA is asked for
    and absent, or when LOCAL_RANK names a card the host does not have."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0) or 0)
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(f"LOCAL_RANK={local} but this host has {count} CUDA device(s)")
        dev = torch.device("cuda", local)
    return dev

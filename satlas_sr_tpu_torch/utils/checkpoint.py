"""Network weights for the inference CLIs.

Only the reference .pth format is ported so far. The JAX package's native
.msgpack/.ckpt files (flax msgpack with an integrity footer) need their own
reader, which a later slice adds with the first trainer.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .torch_io import drop_shared_fusion_levels, load_torch_state_dict

_PTH_ARCHS = ("SSR_RRDBNet", "SRCNN", "HighResNet")


def load_network_variables(arch_type: str, path: str, arch_opt: Optional[Dict] = None,
                           param_key: Optional[str] = "params_ema") -> Dict[str, torch.Tensor]:
    """A reference-format .pth -> the port's state dict for `arch_type`,
    honouring `param_key` with the params_ema -> params fallback."""
    if path.endswith((".msgpack", ".ckpt")):
        raise NotImplementedError(
            f"{path}: .msgpack/.ckpt weights are not yet ported; use a reference .pth")
    if arch_type not in _PTH_ARCHS:
        raise NotImplementedError(f"No .pth importer for arch {arch_type!r} "
                                  f"(ported: {list(_PTH_ARCHS)})")
    state = load_torch_state_dict(path, param_key)
    return drop_shared_fusion_levels(state) if arch_type == "HighResNet" else state

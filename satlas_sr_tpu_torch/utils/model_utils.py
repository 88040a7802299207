"""Network construction for the inference CLIs, from an infer config's `network_g`.

SSR_RRDBNet takes n_lr_images * channels_per_frame(s2_bands) input channels
(3 per frame for tci-only input); SRCNN and HighResNet take the revisits as
a 5-D [B, T, H, W, C] stack (`uses_3d_input`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..archs import SRCNN, HighResNet, RRDBNet
from .infer_utils import channels_per_frame

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(opt: Dict[str, Any]) -> torch.dtype:
    """The config's compute dtype: float32 or bfloat16 (the rdb kernel's)."""
    name = str(opt.get("compute_dtype", "float32"))
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype {name!r} not supported: use float32 or bfloat16")
    return _DTYPES[name]


def uses_3d_input(network_type: str) -> bool:
    """True for the families that take [B, T, H, W, C] revisit stacks."""
    return network_type in ("SRCNN", "HighResNet")


def config_scale(opt: Dict[str, Any]) -> int:
    """The config's `scale`, or network_g's where only it has one (as in
    options/infer_grid_{halo,whole_tile}.yml)."""
    scale = opt.get("scale", opt["network_g"].get("scale"))
    if scale is None:
        raise KeyError("the config sets no scale (top level or network_g)")
    return int(scale)


def build_network(opt: Dict[str, Any], device="cuda"):
    """Build the generator for an infer config."""
    model_opt = opt["network_g"]
    model_type = model_opt["type"]
    n_lr_images = int(opt["n_lr_images"])
    if model_type == "SSR_RRDBNet":
        return RRDBNet(
            num_in_ch=n_lr_images * channels_per_frame(opt.get("s2_bands")),
            num_out_ch=3,
            scale=config_scale(opt),
            num_feat=int(model_opt["num_feat"]),
            num_block=int(model_opt["num_block"]),
            num_grow_ch=int(model_opt["num_grow_ch"]),
            dtype=compute_dtype(opt),
            device=device,
        )
    if uses_3d_input(model_type):
        cls = SRCNN if model_type == "SRCNN" else HighResNet
        return cls(
            in_channels=int(model_opt["in_channels"]),
            mask_channels=int(model_opt.get("mask_channels", 0)),
            revisits=n_lr_images,
            hidden_channels=int(model_opt["hidden_channels"]),
            out_channels=int(model_opt["out_channels"]),
            kernel_size=int(model_opt["kernel_size"]),
            residual_layers=int(model_opt["residual_layers"]),
            output_size=model_opt["output_size"],
            zoom_factor=config_scale(opt),
            sr_kernel_size=int(model_opt["sr_kernel_size"]),
            use_reference_frame=bool(model_opt.get("use_reference_frame", False)),
            dtype=compute_dtype(opt),
            device=device,
        )
    raise ValueError(f"Model type {model_type!r} not supported")

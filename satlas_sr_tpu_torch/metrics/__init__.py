"""Metric registry package + dispatcher (the JAX package's `metrics/__init__.py`).

`calculate_metric(data, opt, device)` pops `type`, looks it up in the
registry and calls it with the metric data (uint8 HWC `img`, `img2`), the
config kwargs and the device: the tower metrics (LPIPS, CLIPScore) compute
there, the others (psnr, ssim, cpsnr) in numpy on the host.
"""

from ..registry import METRIC_REGISTRY
from . import clipscore, cpsnr, lpips, psnr_ssim  # noqa: F401  (register)
from .cpsnr import calculate_cpsnr
from .psnr_ssim import calculate_psnr, calculate_ssim


def calculate_metric(data: dict, opt: dict, device="cuda"):
    opt = dict(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt, device=device)


def metric_tower_pretrained(opt: dict):
    """None if the metric is weight-free (psnr/ssim/cpsnr); else whether its
    tower carries real pretrained weights. Random-tower results are
    self-consistent only and get tagged `(untrained-tower)` in reports."""
    kwargs = {k: v for k, v in opt.items() if k not in ("type", "better")}
    t = opt.get("type")
    if t == "calculate_lpips":
        return lpips.tower_pretrained(**kwargs)
    if t == "calculate_clipscore":
        return clipscore.tower_pretrained(**kwargs)
    return None


__all__ = [
    "calculate_metric",
    "calculate_psnr",
    "calculate_ssim",
    "calculate_cpsnr",
    "metric_tower_pretrained",
]

"""Metric registry package + dispatcher (the JAX package's `metrics/__init__.py`).

`calculate_metric(data, opt)` pops `type`, looks it up in the registry and
calls it with the metric data (uint8 HWC `img`, `img2`) plus the config
kwargs. The weight-free metrics (psnr, ssim, cpsnr) are ported; the
pretrained-tower metrics (LPIPS, CLIPScore) are not yet, and a config that
names one is refused by `check_ported` when the model is built, before any
data is read, rather than dropped or faked.
"""

from ..registry import METRIC_REGISTRY
from . import cpsnr, psnr_ssim  # noqa: F401  (register)
from .cpsnr import calculate_cpsnr
from .psnr_ssim import calculate_psnr, calculate_ssim

#: metric type -> the JAX module that holds it, for what is not yet ported
NOT_PORTED = {
    "calculate_lpips": "satlas_sr_tpu/metrics/lpips.py",
    "calculate_clipscore": "satlas_sr_tpu/metrics/clipscore.py",
}


def check_ported(metrics: dict) -> None:
    """Raise NotImplementedError for a metric whose type is not yet ported."""
    for name, m_opt in (metrics or {}).items():
        t = (m_opt or {}).get("type")
        if t in NOT_PORTED:
            raise NotImplementedError(
                f"metric {name!r} ({t}, {NOT_PORTED[t]}) is not yet ported: its pretrained "
                "tower comes with ROADMAP queue 1 item 12; narrow the config's metrics to "
                "calculate_psnr, calculate_ssim and calculate_cpsnr")


def calculate_metric(data: dict, opt: dict):
    opt = dict(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)


def metric_tower_pretrained(opt: dict):
    """None for a weight-free metric (psnr/ssim/cpsnr), which is all the port
    has: a tower metric is refused at model build (`check_ported`) before it
    could be tagged `(untrained-tower)`."""
    return None


__all__ = [
    "calculate_metric",
    "calculate_psnr",
    "calculate_ssim",
    "calculate_cpsnr",
    "check_ported",
    "metric_tower_pretrained",
]

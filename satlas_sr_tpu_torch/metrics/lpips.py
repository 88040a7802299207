"""LPIPS perceptual distance (vgg and alex backbones), the JAX package's
`metrics/lpips.py` (ssr/metrics/lpips.py:7-21: the lpips package; the
shipped configs use `vgg`).

Weights come from a local combined state dict (torchvision
`features.{i}.weight` convs plus the lpips package's `lin{i}.model.1.weight`
or `lins.{i}.model.1.weight` heads) named by `lpips_weights_path` or the
environment variable SSR_TPU_LPIPS_WEIGHTS. Without one (or with a file
whose convs do not fit the plan) the backbone is the JAX package's seeded
He-normal draw from np.random.RandomState(0), with no heads, a warning
logged, and the metric tagged `(untrained-tower)` (metrics/__init__.py).

As the reference calls it: the [0, 1] image goes straight into the lpips
scaling layer, with no 2x - 1 remap (the lpips package remaps only under
normalize=True, which the reference leaves False); max-pools floor; each
tap is unit-normalised over channels with rsqrt(sum x^2 + 1e-10); a tap
with a head sums its weighted squared differences over channels, one
without takes their channel mean; the spatial means are summed over taps.
The backbone is built once per (model, weights path, device) and process
and computes in float32 on the device the caller names (validation passes
the model's).
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..registry import METRIC_REGISTRY
from .clip_encoder import device_key

# Backbone plans: ("conv", out_ch, kernel, stride, pad, tap) | ("pool", kernel, stride).
# A tap is taken after the ReLU of each conv marked tap=True (the lpips
# package's five slice boundaries).
_PLANS: Dict[str, List[tuple]] = {
    # torchvision VGG16.features; taps = relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
    "vgg": [
        ("conv", 64, 3, 1, 1, False), ("conv", 64, 3, 1, 1, True), ("pool", 2, 2),
        ("conv", 128, 3, 1, 1, False), ("conv", 128, 3, 1, 1, True), ("pool", 2, 2),
        ("conv", 256, 3, 1, 1, False), ("conv", 256, 3, 1, 1, False),
        ("conv", 256, 3, 1, 1, True), ("pool", 2, 2),
        ("conv", 512, 3, 1, 1, False), ("conv", 512, 3, 1, 1, False),
        ("conv", 512, 3, 1, 1, True), ("pool", 2, 2),
        ("conv", 512, 3, 1, 1, False), ("conv", 512, 3, 1, 1, False),
        ("conv", 512, 3, 1, 1, True),
    ],
    # torchvision AlexNet.features; taps = relu1..relu5
    "alex": [
        ("conv", 64, 11, 4, 2, True), ("pool", 3, 2),
        ("conv", 192, 5, 1, 2, True), ("pool", 3, 2),
        ("conv", 384, 3, 1, 1, True),
        ("conv", 256, 3, 1, 1, True),
        ("conv", 256, 3, 1, 1, True),
    ],
}

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _plan_convs(plan) -> List[tuple]:
    return [item for item in plan if item[0] == "conv"]


def _init_backbone(plan, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    convs = []
    in_ch = 3
    for _, out_ch, k, _, _, _ in _plan_convs(plan):
        fan_in = k * k * in_ch
        convs.append({
            "kernel": (rng.randn(k, k, in_ch, out_ch) * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "bias": np.zeros((out_ch,), np.float32),
        })
        in_ch = out_ch
    return convs


def _load_lpips_torch(path: str, plan) -> Optional[tuple]:
    """(convs in HWIO, heads) from a combined checkpoint, or None when its
    convs do not fit the plan."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    conv_keys = sorted(
        (k for k in state if k.endswith(".weight") and "lin" not in k),
        key=lambda k: [int(t) for t in k.split(".") if t.isdigit()],
    )
    plan_convs = _plan_convs(plan)
    if len(conv_keys) != len(plan_convs):
        return None
    convs = []
    for key, (_, out_ch, ksz, _, _, _) in zip(conv_keys, plan_convs):
        w = state[key].float().numpy()  # OIHW
        if w.shape[0] != out_ch or w.shape[2] != ksz:
            return None
        b = state.get(key[:-7] + ".bias")
        convs.append({
            "kernel": np.transpose(w, (2, 3, 1, 0)),
            "bias": b.float().numpy() if b is not None else np.zeros(w.shape[0], np.float32),
        })
    lins = []
    i = 0
    while f"lin{i}.model.1.weight" in state or f"lins.{i}.model.1.weight" in state:
        k = f"lin{i}.model.1.weight" if f"lin{i}.model.1.weight" in state else f"lins.{i}.model.1.weight"
        lins.append(state[k].float().numpy().reshape(-1))  # [C]
        i += 1
    return convs, lins


class LPIPS(nn.Module):
    """forward(a, b): NHWC float32 in [0, 1] -> [B] LPIPS distances."""

    def __init__(self, plan, convs: List[Dict[str, np.ndarray]],
                 lins: Optional[List[np.ndarray]] = None):
        super().__init__()
        self.plan = plan
        self.weights = nn.ParameterList(
            torch.from_numpy(np.ascontiguousarray(c["kernel"].transpose(3, 2, 0, 1))) for c in convs)
        self.biases = nn.ParameterList(torch.from_numpy(c["bias"]) for c in convs)
        self.lins = nn.ParameterList(torch.from_numpy(v) for v in (lins or []))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, ci = [], 0
        h = x
        for item in self.plan:
            if item[0] == "pool":
                h = F.max_pool2d(h, item[1], item[2])  # padding 0, floor: torch's MaxPool2d
                continue
            _, _, _, stride, pad, tap = item
            h = F.relu(F.conv2d(h, self.weights[ci], self.biases[ci], stride=stride, padding=pad))
            if tap:
                feats.append(h)
            ci += 1
        return feats

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        # [0, 1] straight into the scaling layer (no 2x - 1), as the reference
        fa = self._features((a.permute(0, 3, 1, 2) - self.shift) / self.scale)
        fb = self._features((b.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa * torch.rsqrt(xa.square().sum(dim=1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt(xb.square().sum(dim=1, keepdim=True) + 1e-10)
            d = (na - nb).square()
            if i < len(self.lins):
                d = (d * self.lins[i].view(1, -1, 1, 1)).sum(dim=1)
            else:
                d = d.mean(dim=1)
            total = total + d.mean(dim=(1, 2))
        return total


@functools.lru_cache(maxsize=4)
def _backbone(model_name: str, weights_path: Optional[str]) -> Tuple[list, Optional[list], bool]:
    """(convs, heads or None, pretrained), read or drawn once per process."""
    if model_name not in _PLANS:
        raise ValueError(f"lpips_model={model_name!r} not supported (vgg | alex)")
    plan = _PLANS[model_name]
    weights_path = os.path.expanduser(weights_path) if weights_path else None
    if weights_path and os.path.exists(weights_path):
        loaded = _load_lpips_torch(weights_path, plan)
        if loaded:
            return loaded[0], loaded[1], True
    logging.getLogger("satlas_sr_tpu_torch").warning(
        "LPIPS: no local weights (set SSR_TPU_LPIPS_WEIGHTS); using seeded "
        "random backbone — distances are self-consistent only.")
    return _init_backbone(plan), None, False


@functools.lru_cache(maxsize=4)
def _build_lpips(model_name: str, weights_path: Optional[str], device: str) -> LPIPS:
    convs, lins, _ = _backbone(model_name, weights_path)
    module = LPIPS(_PLANS[model_name], convs, lins)
    return module.to(device).requires_grad_(False).eval()


def _weights(lpips_weights_path):
    return lpips_weights_path or os.environ.get("SSR_TPU_LPIPS_WEIGHTS")


def tower_pretrained(lpips_model="vgg", lpips_weights_path=None, **kwargs) -> bool:
    """True iff the LPIPS backbone has real (non-random) weights loaded."""
    try:
        return _backbone(lpips_model, _weights(lpips_weights_path))[2]
    except ValueError:
        return False


@METRIC_REGISTRY.register("calculate_lpips")
def calculate_lpips(img, img2, lpips_model="vgg", lpips_weights_path=None, device="cuda",
                    **kwargs) -> float:
    """uint8 HWC images -> LPIPS distance (lower better), computed on `device`."""
    dev = device_key(device)
    module = _build_lpips(lpips_model, _weights(lpips_weights_path), dev)
    a = torch.from_numpy(np.asarray(img)).to(dev).float()[None] / 255.0
    b = torch.from_numpy(np.asarray(img2)).to(dev).float()[None] / 255.0
    with torch.no_grad():
        return float(module(a, b)[0])

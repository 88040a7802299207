"""VGG19 feature tower for the perceptual loss (the JAX package's `losses/vgg.py`).

The reference's perceptual loss runs torchvision's pretrained VGG19 and taps
pre-ReLU conv activations (conv1_2 .. conv5_4 in esrgan_s2naip_urban.yml).
Pretrained weights come from a local torchvision-format .pth
(`vgg_weights_path`, or the environment variable SSR_TPU_VGG19_WEIGHTS, as
the JAX package reads it); there is no download. Without one, the tower is
the JAX package's seeded He-normal fallback, copied here: the same numpy
RandomState draws, so both packages build the same tower from one seed.
Parameters are numpy HWIO in the JAX layout; `torch_params` turns them
into OIHW tensors.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.halo import conv2d_band

# VGG19 conv plan: (name, out_channels); 'M' = 2x2 maxpool.
VGG19_PLAN: List = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512), "M",
]

# torchvision vgg19.features Sequential indices of the conv layers, in order.
_TORCHVISION_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=2)
def init_vgg19_params(seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Deterministic He-normal random VGG19 params, HWIO (the fallback when
    no weights are given). Drawn once a process and seed (20M draws; every
    trainer build asks): the arrays are shared, and read, never written."""
    rng = np.random.RandomState(seed)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    in_ch = 3
    for item in VGG19_PLAN:
        if item == "M":
            continue
        name, out_ch = item
        fan_in = 9 * in_ch
        params[name] = {
            "kernel": (rng.randn(3, 3, in_ch, out_ch) * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "bias": np.zeros((out_ch,), np.float32),
        }
        in_ch = out_ch
    return params


def load_vgg19_from_torch(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """A torchvision vgg19 state dict (.pth) -> the named HWIO params."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    conv_names = [item[0] for item in VGG19_PLAN if item != "M"]
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for name, idx in zip(conv_names, _TORCHVISION_CONV_IDX):
        w = state[f"features.{idx}.weight"].numpy()  # OIHW
        params[name] = {"kernel": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),
                        "bias": state[f"features.{idx}.bias"].numpy().astype(np.float32)}
    return params


def get_vgg19_params(weights_path: str = None, seed: int = 0) -> Tuple[Dict, bool]:
    """(params, pretrained): the local weights if found, else the seeded tower."""
    path = weights_path or os.environ.get("SSR_TPU_VGG19_WEIGHTS")
    path = os.path.expanduser(path) if path else path
    if path and os.path.exists(path):
        return load_vgg19_from_torch(path), True
    return init_vgg19_params(seed), False


def torch_params(params: Dict[str, Dict[str, np.ndarray]], device="cpu",
                 dtype: torch.dtype = torch.float32) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """HWIO numpy params -> {name: (OIHW weight, bias)} on `device` in `dtype`."""
    return {name: (torch.from_numpy(np.ascontiguousarray(np.transpose(p["kernel"], (3, 2, 0, 1))))
                   .to(device=device, dtype=dtype),
                   torch.from_numpy(np.asarray(p["bias"])).to(device=device, dtype=dtype))
            for name, p in params.items()}


def band_factor(taps: Sequence[str]) -> int:
    """What the rows of a band must divide by for `vgg19_features` on it:
    2 to the number of pools before the deepest tap."""
    deepest = max(i for i, item in enumerate(VGG19_PLAN) if item != "M" and item[0] in taps)
    return 2 ** sum(item == "M" for item in VGG19_PLAN[:deepest])


def vgg19_features(params: Dict[str, Tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor,
                   taps: Sequence[str], use_input_norm: bool = True, range_norm: bool = False,
                   dtype: torch.dtype = torch.float32, space=None) -> Dict[str, torch.Tensor]:
    """Run the VGG19 trunk on NHWC input in [0, 1]; return the pre-ReLU taps
    (NCHW, channels-last), stopping at the deepest one. `params` from
    `torch_params`, in `dtype`. The input norm runs in x's dtype, the convs
    in `dtype`, as the JAX tower does.

    With `space` (a mesh.SpaceLayout) x is this rank's row band of an image
    split over the group and the taps are the band's rows: each conv takes
    one halo row a side (parallel/halo.conv2d_band), each pool its band's
    row pairs, so the rows must divide by `band_factor(taps)`."""
    taps = list(taps)
    deepest = max(i for i, item in enumerate(VGG19_PLAN) if item != "M" and item[0] in taps)
    if space is not None and x.shape[1] % band_factor(taps):
        raise ValueError(f"a VGG19 band of {x.shape[1]} rows does not divide by "
                         f"{band_factor(taps)} (the pools before {VGG19_PLAN[deepest][0]})")
    if range_norm:
        x = (x + 1.0) / 2.0
    if use_input_norm:
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = (x - mean) / std
    h = x.to(dtype).permute(0, 3, 1, 2)
    out: Dict[str, torch.Tensor] = {}
    for i, item in enumerate(VGG19_PLAN):
        if item == "M":
            h = F.max_pool2d(h, 2)  # floors odd sizes, as the JAX slicing max does
            continue
        name, _ = item
        w, b = params[name]
        h = F.conv2d(h, w, b, padding=1) if space is None else conv2d_band(h, w, b, space)
        if name in taps:
            out[name] = h
        if i >= deepest:
            break
        h = torch.relu(h)
    return out

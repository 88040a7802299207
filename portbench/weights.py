"""The cells' weights and inputs, drawn on the device from `--seed`.

Every tensor of a state dict comes out of one flat draw per distribution
(`draw`), made by a torch.Generator on the run's device in the dtype they
are given in, and sliced. The same seed gives the same tensors on the same
device. Streams are split by a fixed offset per use (the generator's
weights, the inputs), so adding one never moves another.

The distributions keep the outputs in range with random weights, so that a
comparison of outputs compares computed values and not clamps, and let the
trunk carry a trained network's share of them:
- the dense blocks' convs He normal (Kaiming, fan in). ESRGAN's init
  scales them by 0.1 for training from scratch; at that scale the 69 blocks
  move the output so little that a trunk computed in TF32 instead of float32
  reads as close to the reference as a sound run (PERF.md);
- the heads Lecun normal; conv_last at a gain that puts the image's values
  around 0.5 (its bias) with a spread of about 0.15-0.25; biases N(0, 0.01).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

STREAMS = {"g": 1, "inputs": 4}
#: conv_last's gain on its Lecun std and its bias: the output's spread and centre
LAST_GAIN, LAST_BIAS = 0.01, 0.5


def generator(seed: int, stream: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 8 + STREAMS[stream]) % (1 << 63))
    return gen


Spec = Tuple[str, Tuple[int, ...], str, float]  # name, shape, "normal" | "const", scale


def draw(specs: List[Spec], gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One normal draw for all of `specs`, sliced and scaled: normal ->
    N(0, scale^2), const -> scale."""
    normal = [s for s in specs if s[2] == "normal"]
    flat = torch.empty(sum(math.prod(s[1]) for s in normal), device=device)
    flat.normal_(generator=gen)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, _, scale in normal:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(scale)
        at += n
    for name, shape, kind, scale in specs:
        if kind == "const":
            out[name] = torch.full(shape, float(scale), device=device)
    return {name: out[name] for name, _, _, _ in specs}


def on_meta(specs: List[Spec]) -> Dict[str, torch.Tensor]:
    """Tensors of the specs' shapes on the meta device, for counting FLOPs."""
    return {name: torch.empty(shape, device="meta") for name, shape, _, _ in specs}


def _conv(name: str, cin: int, cout: int, k: int, std: float, bias_std: float = 0.01) -> List[Spec]:
    return [(f"{name}.weight", (cout, cin, k, k), "normal", std),
            (f"{name}.bias", (cout,), "normal", bias_std)]


def rrdbnet_specs(net: Dict) -> List[Spec]:
    """Specs of SSR_RRDBNet at scale 4 (`network_g` of a config)."""
    cin, cout = int(net["num_in_ch"]), int(net["num_out_ch"])
    nf, g, nb = int(net["num_feat"]), int(net["num_grow_ch"]), int(net["num_block"])
    lecun = lambda fan: 1.0 / math.sqrt(fan * 9)
    specs = _conv("conv_first", cin, nf, 3, lecun(cin))
    for i in range(nb):
        for j in (1, 2, 3):
            for k in range(5):
                ci = nf + k * g
                specs += _conv(f"body.{i}.rdb{j}.conv{k + 1}", ci, g if k < 4 else nf, 3,
                               math.sqrt(2.0 / (ci * 9)))
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        specs += _conv(name, nf, nf, 3, lecun(nf))
    specs += [("conv_last.weight", (cout, nf, 3, 3), "normal", LAST_GAIN * lecun(nf)),
              ("conv_last.bias", (cout,), "const", LAST_BIAS)]
    return specs


def rrdbnet_weights(net: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return draw(rrdbnet_specs(net), generator(seed, "g", device), device)


def uint8_images(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform uint8 values of `shape` on `device`."""
    return torch.randint(0, 256, tuple(shape), generator=gen, device=device, dtype=torch.uint8)

"""Reference-format .pth state dicts, and weights carried across from the JAX package.

The released reference checkpoints (esrgan_*.pth, srcnn_s2naip.pth,
highresnet_s2naip.pth) are torch state dicts under `params` / `params_ema`;
the port's RRDBNet, SRCNN, HighResNet and U-Net discriminator use the same
names, so they load with load_state_dict. The OSM-object discriminator
keeps its U-Net under `unet`, where the reference names those convs at the
top level: `osm_disc_to_reference` / `osm_disc_from_reference` rename.
`rrdbnet_from_jax`, `unet_disc_from_jax`, `osm_disc_from_jax`,
`srcnn_from_jax` and `highresnet_from_jax` turn the JAX package's flax
variables (as numpy arrays) into the port's state dicts; `tower_from_jax`
does the same for a CLIP/SigLIP/EVA/RN tower's nested param dict
(metrics/clip_encoder.py), and `dense_block_from_jax`,
`conv_transpose_block_from_jax`, `residual_block_nobn_from_jax`,
`upsample_from_jax` and `dcnv2_pack_from_jax` for the blocks of
archs/blocks.py that no registered arch uses.

The way back: `rrdbnet_to_jax`, `unet_disc_to_jax`, `osm_disc_to_jax`,
`srcnn_to_jax` and `highresnet_to_jax` give the JAX package's flax
variables ({"params": ..., "spectral": ...} of numpy arrays, the trunk
stacked) for a port state dict, each the exact inverse of its `*_from_jax`.
`adam_state_from_jax` turns an optax Adam state (the `(count, mu, nu)` of
scale_by_adam, alone or inside the add_decayed_weights chain) into a torch
Adam state dict through the same parameter converter.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_HEADS = ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_up3", "conv_up4",
          "conv_hr", "conv_last")


def load_torch_state_dict(path: str, param_key: Optional[str] = "params_ema") -> Dict[str, torch.Tensor]:
    """Read a .pth file -> {name: tensor}. Falls back from a missing
    `param_key` to params_ema, then params, with a warning."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if param_key and param_key in state:
        state = state[param_key]
    elif "params_ema" in state or "params" in state:
        fallback = "params_ema" if "params_ema" in state else "params"
        if param_key:
            logging.getLogger("satlas_sr_tpu_torch").warning(
                "checkpoint %s has no key %r; falling back to %r", path, param_key, fallback)
        state = state[fallback]
    return dict(state)


def save_torch_state_dict(path: str, state: Mapping[str, Any], param_key: str = "params") -> None:
    """Write {name: tensor or array} as a reference-format .pth under `param_key`."""
    tensors = {k: torch.as_tensor(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
               else v.detach().cpu().contiguous() for k, v in state.items()}
    torch.save({param_key: tensors}, path)


def _oihw(kernel_hwio) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel_hwio), (3, 2, 0, 1))))


def rrdbnet_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX RRDBNet's flax variables (numpy arrays) -> the port's state dict.

    Conv kernels go HWIO -> OIHW, and the scanned trunk (every leaf stacked on
    a leading axis of size num_block) is unstacked into body.{i}.
    """
    params = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}
    for name in _HEADS:
        if name in params:
            out[f"{name}.weight"] = _oihw(params[name]["kernel"])
            out[f"{name}.bias"] = torch.from_numpy(np.array(params[name]["bias"]))
    block = params["body"]["block"]
    for rdb, convs in block.items():
        for conv, p in convs.items():
            kernels, biases = np.asarray(p["kernel"]), np.asarray(p["bias"])
            for i in range(kernels.shape[0]):
                out[f"body.{i}.{rdb}.{conv}.weight"] = _oihw(kernels[i])
                out[f"body.{i}.{rdb}.{conv}.bias"] = torch.from_numpy(np.array(biases[i]))
    return out


def unet_disc_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX U-Net SN discriminator's variables (numpy arrays: `params`
    and the `spectral` u/v collection) -> the port's state dict, the
    reference's names: conv{1..8}.weight_orig/weight_u/weight_v."""
    params, spectral = variables["params"], variables.get("spectral", {})
    out: Dict[str, torch.Tensor] = {}
    for name in ("conv0", "conv9"):
        _conv_from_jax(params[name], out, name)
    for i in range(1, 9):
        name = f"conv{i}"
        out[f"{name}.weight_orig"] = _oihw(params[name]["kernel"])
        for key in ("u", "v"):
            if key in spectral.get(name, {}):
                out[f"{name}.weight_{key}"] = torch.from_numpy(np.array(spectral[name][key]))
    return out


_OSM_BRANCH = ("o_conv", "o_attention")


def osm_disc_to_reference(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's OSMObjDiscriminator state dict -> the reference .pth names
    (the U-Net's conv0..conv9 and u/v at the top level)."""
    return {k[len("unet."):] if k.startswith("unet.") else k: v for k, v in state.items()}


def osm_disc_from_reference(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of osm_disc_to_reference."""
    return {k if k.startswith(_OSM_BRANCH) else f"unet.{k}": v for k, v in state.items()}


def osm_disc_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX OSMObjDiscriminator's variables (numpy arrays: `params`, and
    `spectral` u/v of its U-Net) -> the port's state dict."""
    params = variables["params"]
    spectral = (variables.get("spectral") or {}).get("unet", {})
    out = {f"unet.{k}": v for k, v in
           unet_disc_from_jax({"params": params["unet"], "spectral": spectral}).items()}
    for i in range(1, 5):
        _conv_from_jax(params[f"o_conv{i}"], out, f"o_conv{i}")
    for i in (1, 2):
        base, p = f"o_attention{i}", params[f"o_attention{i}"]
        for part in ("query", "key", "value"):
            _conv_from_jax(p[part], out, f"{base}.{part}_conv")
        out[f"{base}.gamma"] = torch.from_numpy(np.array(p["gamma"]))
    return out


def _hwio(weight: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_numpy(weight), (2, 3, 1, 0)))


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _conv_to_jax(state: Mapping[str, torch.Tensor], name: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _hwio(state[f"{name}.weight"])}
    if f"{name}.bias" in state:
        out["bias"] = _numpy(state[f"{name}.bias"]).copy()
    return out


def rrdbnet_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's RRDBNet state dict -> the JAX RRDBNet's flax variables
    (HWIO kernels, the trunk stacked on a leading num_block axis)."""
    params: Dict[str, Any] = {name: _conv_to_jax(state, name) for name in _HEADS
                              if f"{name}.weight" in state}
    num_block = len({k.split(".")[1] for k in state if k.startswith("body.")})
    params["body"] = {"block": {
        rdb: {conv: {"kernel": np.stack([_hwio(state[f"body.{i}.{rdb}.{conv}.weight"])
                                         for i in range(num_block)]),
                     "bias": np.stack([_numpy(state[f"body.{i}.{rdb}.{conv}.bias"])
                                       for i in range(num_block)])}
              for conv in ("conv1", "conv2", "conv3", "conv4", "conv5")}
        for rdb in ("rdb1", "rdb2", "rdb3")}}
    return {"params": params}


def unet_disc_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's U-Net SN discriminator state dict -> the JAX one's
    variables: `params` and the `spectral` u/v collection."""
    params: Dict[str, Any] = {"conv0": _conv_to_jax(state, "conv0"),
                              "conv9": _conv_to_jax(state, "conv9")}
    spectral: Dict[str, Any] = {}
    for i in range(1, 9):
        name = f"conv{i}"
        params[name] = {"kernel": _hwio(state[f"{name}.weight_orig"])}
        uv = {key: _numpy(state[f"{name}.weight_{key}"]).copy() for key in ("u", "v")
              if f"{name}.weight_{key}" in state}
        if uv:
            spectral[name] = uv
    params = {k: params[k] for k in sorted(params)}
    return {"params": params, "spectral": spectral} if spectral else {"params": params}


def osm_disc_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's OSMObjDiscriminator state dict -> the JAX one's variables
    (the U-Net under `unet`, its u/v under spectral.unet)."""
    unet = unet_disc_to_jax({k[len("unet."):]: v for k, v in state.items()
                             if k.startswith("unet.")})
    params: Dict[str, Any] = {"unet": unet["params"]}
    for i in range(1, 5):
        params[f"o_conv{i}"] = _conv_to_jax(state, f"o_conv{i}")
    for i in (1, 2):
        base = f"o_attention{i}"
        params[base] = {"query": _conv_to_jax(state, f"{base}.query_conv"),
                        "key": _conv_to_jax(state, f"{base}.key_conv"),
                        "value": _conv_to_jax(state, f"{base}.value_conv"),
                        "gamma": _numpy(state[f"{base}.gamma"]).copy()}
    out = {"params": params}
    if "spectral" in unet:
        out["spectral"] = {"unet": unet["spectral"]}
    return out


def _doubleconv_to_jax(state: Mapping[str, torch.Tensor], base: str) -> Dict[str, Any]:
    return {"conv1": _conv_to_jax(state, f"{base}.0"),
            "prelu1": {"weight": _numpy(state[f"{base}.2.weight"]).copy()},
            "conv2": _conv_to_jax(state, f"{base}.4"),
            "prelu2": {"weight": _numpy(state[f"{base}.6.weight"]).copy()}}


def _revisit_heads_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    params = {"encoder": _doubleconv_to_jax(state, "encoder.doubleconv2d"),
              "sr": {"conv1": _conv_to_jax(state, "sr.upsample.1"),
                     "prelu1": {"weight": _numpy(state["sr.upsample.3.weight"]).copy()},
                     "conv2": _conv_to_jax(state, "sr.upsample.4"),
                     "prelu2": {"weight": _numpy(state["sr.upsample.6.weight"]).copy()}}}
    if "mask_encoder.1.doubleconv2d.0.weight" in state:
        params["mask_encoder"] = _doubleconv_to_jax(state, "mask_encoder.1.doubleconv2d")
    return params


def srcnn_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's SRCNN state dict -> the JAX SRCNN's flax variables."""
    params = _revisit_heads_to_jax(state)
    params["fusion_conv"] = _doubleconv_to_jax(state, "doubleconv2d.doubleconv2d")
    i = 0
    while f"residualblocks.{i}.residualblock.doubleconv2d.0.weight" in state:
        params[f"fusion_res{i}"] = {
            "body": _doubleconv_to_jax(state, f"residualblocks.{i}.residualblock.doubleconv2d")}
        i += 1
    return {"params": params}


def highresnet_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's HighResNet state dict -> the JAX HighResNet's variables
    (its one shared FusionBlock under fusion.fuse)."""
    params = _revisit_heads_to_jax(state)
    params["fusion"] = {"fuse": {
        "residual": {"body": _doubleconv_to_jax(
            state, "fusion.fusion.0.fuse.0.residualblock.doubleconv2d")},
        "proj": _conv_to_jax(state, "fusion.fusion.0.fuse.1"),
        "prelu": {"weight": _numpy(state["fusion.fusion.0.fuse.3.weight"]).copy()}}}
    return {"params": params}


def _find_adam(tree: Any) -> Optional[Mapping[str, Any]]:
    """The scale_by_adam state ({count, mu, nu}) inside an optax state."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for value in tree.values():
            found = _find_adam(value)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state: Any, to_port, named_params,
                        param_groups) -> Dict[str, Any]:
    """An optax Adam/AdamW state, as flax serialises it ({'0': {count, mu,
    nu}, '1': {count}} for adam, the add_decayed_weights chain's
    {'0': {}, '1': {count, mu, nu}, '2': {count}} for Adam with
    weight_decay) -> a torch Adam state dict for the parameters
    `named_params` ((name, tensor) in optimizer order) with `param_groups`
    taken from the optimizer it is loaded into. mu and nu go through
    `to_port` (the network's `*_from_jax`: HWIO -> OIHW, the trunk
    unstacked); optax's one `count` becomes every parameter's `step`."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no optax scale_by_adam state (count, mu, nu) in this optimizer state")
    count = float(np.asarray(adam["count"]))
    mu, nu = to_port(adam["mu"]), to_port(adam["nu"])
    state = {}
    for i, (name, p) in enumerate(named_params):
        if name not in mu or name not in nu:
            raise KeyError(f"optax state has no moments for parameter {name!r}")
        state[i] = {"step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": mu[name].to(p.dtype).reshape(p.shape).clone(),
                    "exp_avg_sq": nu[name].to(p.dtype).reshape(p.shape).clone()}
    return {"state": state, "param_groups": param_groups}


def _conv_from_jax(p: Mapping[str, Any], out: Dict[str, torch.Tensor], name: str) -> None:
    out[f"{name}.weight"] = _oihw(p["kernel"])
    out[f"{name}.bias"] = torch.from_numpy(np.array(p["bias"]))


def _prelu_from_jax(p: Mapping[str, Any], out: Dict[str, torch.Tensor], name: str) -> None:
    out[f"{name}.weight"] = torch.from_numpy(np.array(p["weight"]))


def _doubleconv_from_jax(p: Mapping[str, Any], out: Dict[str, torch.Tensor], base: str) -> None:
    """DoubleConv2d: convs at Sequential slots 0 and 4, PReLUs at 2 and 6."""
    _conv_from_jax(p["conv1"], out, f"{base}.0")
    _prelu_from_jax(p["prelu1"], out, f"{base}.2")
    _conv_from_jax(p["conv2"], out, f"{base}.4")
    _prelu_from_jax(p["prelu2"], out, f"{base}.6")


def _revisit_heads_from_jax(params: Mapping[str, Any], out: Dict[str, torch.Tensor]) -> None:
    """The encoder, the optional mask encoder and the PixelShuffle SR block."""
    _doubleconv_from_jax(params["encoder"], out, "encoder.doubleconv2d")
    if "mask_encoder" in params:
        _doubleconv_from_jax(params["mask_encoder"], out, "mask_encoder.1.doubleconv2d")
    sr = params["sr"]
    _conv_from_jax(sr["conv1"], out, "sr.upsample.1")
    _prelu_from_jax(sr["prelu1"], out, "sr.upsample.3")
    _conv_from_jax(sr["conv2"], out, "sr.upsample.4")
    _prelu_from_jax(sr["prelu2"], out, "sr.upsample.6")


def srcnn_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX SRCNN's flax variables (numpy arrays) -> the port's state dict."""
    params = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}
    _revisit_heads_from_jax(params, out)
    _doubleconv_from_jax(params["fusion_conv"], out, "doubleconv2d.doubleconv2d")
    i = 0
    while f"fusion_res{i}" in params:
        _doubleconv_from_jax(params[f"fusion_res{i}"]["body"], out,
                             f"residualblocks.{i}.residualblock.doubleconv2d")
        i += 1
    return out


def highresnet_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX HighResNet's flax variables (numpy arrays) -> the port's state
    dict (the one shared FusionBlock under fusion.fusion.0)."""
    params = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}
    _revisit_heads_from_jax(params, out)
    fuse = params["fusion"]["fuse"]
    _doubleconv_from_jax(fuse["residual"]["body"], out,
                         "fusion.fusion.0.fuse.0.residualblock.doubleconv2d")
    _conv_from_jax(fuse["proj"], out, "fusion.fusion.0.fuse.1")
    _prelu_from_jax(fuse["prelu"], out, "fusion.fusion.0.fuse.3")
    return out


def _params(variables: Mapping[str, Any]) -> Mapping[str, Any]:
    return variables.get("params", variables)


def dense_block_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX DenseBlock's variables -> the port's DenseBlock state dict."""
    out: Dict[str, torch.Tensor] = {}
    _doubleconv_from_jax(_params(variables)["body"], out, "residualblock.doubleconv2d")
    return out


def conv_transpose_block_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ConvTransposeBlock's variables -> the port's state dict. The
    flax kernel is [kh, kw, out, in] (lax.conv_transpose with
    transpose_kernel=True), nn.ConvTranspose2d's [in, out, kh, kw]."""
    params = _params(variables)
    out = {"upsample.0.weight": torch.from_numpy(np.ascontiguousarray(
               np.transpose(np.asarray(params["deconv_kernel"]), (3, 2, 0, 1)))),
           "upsample.0.bias": torch.from_numpy(np.array(params["deconv_bias"]))}
    _prelu_from_jax(params["prelu1"], out, "upsample.1")
    _conv_from_jax(params["conv1"], out, "upsample.2")
    _prelu_from_jax(params["prelu2"], out, "upsample.4")
    _conv_from_jax(params["conv2"], out, "upsample.5")
    _prelu_from_jax(params["prelu3"], out, "upsample.7")
    return out


def residual_block_nobn_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ResidualBlockNoBN's variables -> conv1.*, conv2.*."""
    out: Dict[str, torch.Tensor] = {}
    for name in ("conv1", "conv2"):
        _conv_from_jax(_params(variables)[name], out, name)
    return out


def upsample_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX Upsample's conv{i} -> the port's Sequential slot 2i."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in _params(variables).items():
        _conv_from_jax(p, out, str(2 * int(name[len("conv"):])))
    return out


def dcnv2_pack_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX DCNv2Pack's variables -> weight, bias, conv_offset.*."""
    params = _params(variables)
    out = {"weight": _oihw(params["kernel"]), "bias": torch.from_numpy(np.array(params["bias"]))}
    _conv_from_jax(params["conv_offset"], out, "conv_offset")
    return out


def drop_shared_fusion_levels(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A HighResNet .pth may name its one shared FusionBlock once per level
    (fusion.fusion.{k}.*); keep level 0 and check that the others repeat it."""
    out = {}
    for name, value in state.items():
        parts = name.split(".")
        if name.startswith("fusion.fusion.") and parts[2] != "0":
            first = ".".join(parts[:2] + ["0"] + parts[3:])
            if first not in state or not torch.equal(state[first], value):
                raise ValueError(f"{name}: HighResNet shares one FusionBlock across levels, "
                                 f"but this differs from {first}")
            continue
        out[name] = value
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def tower_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A tower's nested JAX-layout param dict (numpy) -> the state dict of
    the port's ViTEncoder / ResNetEncoder. A dict with a `kernel` is a dense
    ([in, out] -> weight [out, in]) or a conv (HWIO -> OIHW) with its `bias`,
    or the folded BatchNorm's `scale` and `shift`; one with a `scale` alone
    is a LayerNorm (scale -> weight); lists index by position; other arrays
    keep their name; ints (a block's static `stride`) are dropped."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix: str) -> None:
        if isinstance(tree, Mapping) and "kernel" in tree:
            k = np.asarray(tree["kernel"])
            out[prefix + "weight"] = _tensor(k.T if k.ndim == 2 else k.transpose(3, 2, 0, 1))
            for name in ("bias", "scale", "shift"):
                if name in tree:
                    out[prefix + name] = _tensor(tree[name])
        elif isinstance(tree, Mapping) and "scale" in tree:
            out[prefix + "weight"] = _tensor(tree["scale"])
            out[prefix + "bias"] = _tensor(tree["bias"])
        elif isinstance(tree, Mapping):
            for key, value in tree.items():
                walk(value, f"{prefix}{key}.")
        elif isinstance(tree, (list, tuple)):
            for i, value in enumerate(tree):
                walk(value, f"{prefix}{i}.")
        elif not isinstance(tree, int):
            out[prefix[:-1]] = _tensor(tree)

    walk(params, "")
    return out

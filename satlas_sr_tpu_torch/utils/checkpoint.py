"""Network weights and training states (the JAX package's `utils/checkpoint.py`).

- Network weights (`load_network_variables`): reference-format .pth state
  dicts under `params` / `params_ema` (renamed to the port's modules where
  they differ), the format the released checkpoints and the port's trainer
  write; and the JAX package's native .msgpack/.ckpt files (flax's
  msgpack of the variables dict, read by the port's own codec,
  utils/msgpack.py), taken through the `*_from_jax` converters. Both honour
  `param_key` with the params_ema -> params fallback.
  `save_pytree` writes such a .msgpack, so a network the port trained
  loads in the JAX package.
- Training states: the port writes a `torch.save` payload (`save_state`);
  the JAX package writes the msgpack of {epoch, iter, state}. `read_state`
  reads either, telling them apart by their bytes (a zip's magic, or a
  msgpack map), never by their name.
Every file written here is atomic (a temporary file, fsync, `os.replace`)
and ends in the JAX package's 16-byte integrity footer (magic, crc32 of the
payload, payload length), so a file torn by a kill mid-write is detected
(`verify_state_file`, CheckpointCorruptError) instead of feeding garbage
into a long run. Footer-less JAX files of its first round still load; their
corruption surfaces as a parse error, raised the same way.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import msgpack
from .torch_io import (drop_shared_fusion_levels, highresnet_from_jax, load_torch_state_dict,
                       osm_disc_from_jax, osm_disc_from_reference, rrdbnet_from_jax,
                       srcnn_from_jax, unet_disc_from_jax)

_PTH_ARCHS = ("SSR_RRDBNet", "SRCNN", "HighResNet", "SSR_UNetDiscriminatorSN",
              "OSMObjDiscriminator")

#: arch type -> the converter of its JAX variables ({"params", "spectral"})
FROM_JAX = {"SSR_RRDBNet": rrdbnet_from_jax, "SRCNN": srcnn_from_jax,
            "HighResNet": highresnet_from_jax, "SSR_UNetDiscriminatorSN": unet_disc_from_jax,
            "OSMObjDiscriminator": osm_disc_from_jax}

_FOOTER_MAGIC = b"SSRT"
_FOOTER = struct.Struct("<4sIQ")  # magic, crc32(payload), payload length
_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's zip container


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its integrity check (torn write, bit rot)."""


def _atomic_write(path: str, data: bytes) -> None:
    """`data` and its integrity footer to `path`, atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    footer = _FOOTER.pack(_FOOTER_MAGIC, zlib.crc32(data) & 0xFFFFFFFF, len(data))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.write(footer)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def has_crc_footer(blob: bytes) -> bool:
    return len(blob) >= _FOOTER.size and blob[-_FOOTER.size:][:4] == _FOOTER_MAGIC


def payload_of(blob: bytes, path: str = "<bytes>") -> bytes:
    """A file's payload, its footer verified (the whole blob for a
    footer-less file); raises CheckpointCorruptError on a truncated file or
    a crc mismatch."""
    if not has_crc_footer(blob):
        return blob
    _, crc, length = _FOOTER.unpack(blob[-_FOOTER.size:])
    data = blob[:-_FOOTER.size]
    if len(data) != length:
        raise CheckpointCorruptError(f"{path}: truncated checkpoint ({len(data)} of {length} bytes)")
    if (zlib.crc32(data) & 0xFFFFFFFF) != crc:
        raise CheckpointCorruptError(f"{path}: checkpoint crc mismatch")
    return data


def read_payload(path: str) -> bytes:
    with open(path, "rb") as f:
        return payload_of(f.read(), path)


def _restore(data: bytes, path: str) -> Any:
    try:
        return msgpack.restore(data)
    except msgpack.MsgpackError as e:
        raise CheckpointCorruptError(f"{path}: unreadable checkpoint ({e})") from e


def save_pytree(path: str, tree: Any) -> None:
    """flax's msgpack of `tree` (dicts of numpy arrays or tensors) to `path`
    with the footer: the JAX package's `save_pytree`."""
    _atomic_write(path, msgpack.to_bytes(tree))


def load_pytree(path: str) -> Any:
    """A .msgpack/.ckpt or JAX .state file -> its tree (numpy leaves)."""
    return _restore(read_payload(path), path)


def _float_leaves(tree: Any) -> Any:
    """bfloat16 leaves (torch tensors from the codec) as float32 numpy."""
    if isinstance(tree, dict):
        return {k: _float_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def jax_variables_to_port(arch_type: str, variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables ({"params", optional "spectral"}) -> the port's state dict."""
    if arch_type not in FROM_JAX:
        raise NotImplementedError(f"No JAX importer for arch {arch_type!r} "
                                  f"(ported: {sorted(FROM_JAX)})")
    return FROM_JAX[arch_type](_float_leaves(variables))


def load_network_variables(arch_type: str, path: str, arch_opt: Optional[Dict] = None,
                           param_key: Optional[str] = "params_ema") -> Dict[str, torch.Tensor]:
    """A reference-format .pth, or a JAX .msgpack/.ckpt -> the port's state
    dict for `arch_type`, honouring `param_key` with the params_ema ->
    params fallback (a JAX net_g file holds both collections)."""
    if arch_type not in _PTH_ARCHS:
        raise NotImplementedError(f"No weights importer for arch {arch_type!r} "
                                  f"(ported: {list(_PTH_ARCHS)})")
    if path.endswith((".msgpack", ".ckpt")):
        blob = load_pytree(path)
        if not isinstance(blob, dict):
            raise CheckpointCorruptError(f"{path}: not a variables dict")
        variables = dict(blob)
        for key in (param_key, "params_ema", "params"):
            if key and key in blob:
                variables = {k: v for k, v in blob.items() if k not in ("params", "params_ema")}
                variables["params"] = blob[key]
                break
        return jax_variables_to_port(arch_type, variables)
    state = load_torch_state_dict(path, param_key)
    if arch_type == "HighResNet":
        return drop_shared_fusion_levels(state)
    if arch_type == "OSMObjDiscriminator":
        return osm_disc_from_reference(state)
    return state


def save_state(path: str, payload: Any) -> None:
    """`torch.save(payload)` to `path` atomically, with the integrity footer."""
    buf = io.BytesIO()
    torch.save(payload, buf)
    _atomic_write(path, buf.getvalue())


def state_format(payload: bytes) -> str:
    """'torch' for the port's torch.save zip, 'msgpack' for the JAX
    package's state (a msgpack map), by the payload's first bytes."""
    if payload.startswith(_ZIP_MAGIC):
        return "torch"
    if payload[:1] and (0x80 <= payload[0] <= 0x8F or payload[0] in (0xDE, 0xDF)):
        return "msgpack"
    raise CheckpointCorruptError("neither a torch.save zip nor a msgpack map")


def read_state(path: str) -> Tuple[str, Any]:
    """(format, {epoch, iter, state}) of a training state of either format.
    A port state must carry its footer; a JAX one may lack it (its first
    round wrote none). Raises CheckpointCorruptError."""
    with open(path, "rb") as f:
        blob = f.read()
    data = payload_of(blob, path)
    try:
        fmt = state_format(data)
    except CheckpointCorruptError as e:
        raise CheckpointCorruptError(f"{path}: {e}") from None
    if fmt == "torch":
        if data is blob:
            raise CheckpointCorruptError(f"{path}: no integrity footer on a torch training state")
        try:
            return fmt, torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
        except Exception as e:
            raise CheckpointCorruptError(f"{path}: unreadable checkpoint ({e})") from e
    return fmt, _restore(data, path)


def load_state(path: str) -> Any:
    """The {epoch, iter, state} of a training state of either format."""
    return read_state(path)[1]


def verify_state_file(path: str) -> bool:
    """True iff `path` is a readable, integrity-intact training state (a
    footer's crc proves it; a footer-less JAX state is parsed whole)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
        data = payload_of(blob, path)
        if data is blob:
            return state_format(data) == "msgpack" and isinstance(_restore(data, path), dict)
        state_format(data)
        return True
    except (OSError, CheckpointCorruptError):
        return False


def jax_step(value: Any) -> int:
    """A JAX state's int leaf (a 0-d array or a numpy scalar) as an int."""
    return int(np.asarray(value))

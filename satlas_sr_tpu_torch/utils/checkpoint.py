"""Network weights and training states (the JAX package's `utils/checkpoint.py`).

- Network weights: reference-format .pth state dicts under `params` /
  `params_ema` (`load_network_variables`, which renames to the port's
  modules where they differ), the format the released checkpoints and the
  port's trainer both write. The JAX package's native
  .msgpack/.ckpt files need a msgpack reader, which the card machine lacks:
  they are not yet ported.
- Training states (`save_state` / `load_state`): a `torch.save` payload
  written atomically (a temporary file, fsync, `os.replace`) with the JAX
  package's 16-byte integrity footer (magic, crc32 of the payload, payload
  length), so a state torn by a kill mid-write is detected at resume
  (`verify_state_file`) instead of feeding garbage into a long run.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Any, Dict, Optional

import torch

from .torch_io import drop_shared_fusion_levels, load_torch_state_dict, osm_disc_from_reference

_PTH_ARCHS = ("SSR_RRDBNet", "SRCNN", "HighResNet", "SSR_UNetDiscriminatorSN",
              "OSMObjDiscriminator")

_FOOTER_MAGIC = b"SSRT"
_FOOTER = struct.Struct("<4sIQ")  # magic, crc32(payload), payload length


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its integrity check (torn write, bit rot)."""


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
    if arch_type == "HighResNet":
        return drop_shared_fusion_levels(state)
    if arch_type == "OSMObjDiscriminator":
        return osm_disc_from_reference(state)
    return state


def save_state(path: str, payload: Any) -> None:
    """`torch.save(payload)` to `path` atomically, with the integrity footer."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    torch.save(payload, buf)
    data = buf.getvalue()
    footer = _FOOTER.pack(_FOOTER_MAGIC, zlib.crc32(data) & 0xFFFFFFFF, len(data))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.write(footer)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def state_payload(path: str) -> bytes:
    """The payload of a state written by `save_state`, its footer verified;
    raises CheckpointCorruptError."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _FOOTER.size or blob[-_FOOTER.size:][:4] != _FOOTER_MAGIC:
        raise CheckpointCorruptError(f"{path}: no integrity footer (not a port training state)")
    magic, crc, length = _FOOTER.unpack(blob[-_FOOTER.size:])
    data = blob[:-_FOOTER.size]
    if len(data) != length:
        raise CheckpointCorruptError(f"{path}: truncated checkpoint ({len(data)} of {length} bytes)")
    if (zlib.crc32(data) & 0xFFFFFFFF) != crc:
        raise CheckpointCorruptError(f"{path}: checkpoint crc mismatch")
    return data


def load_state(path: str) -> Any:
    """Read a state written by `save_state`, verifying its footer first."""
    return torch.load(io.BytesIO(state_payload(path)), map_location="cpu", weights_only=True)


def verify_state_file(path: str) -> bool:
    """True iff `path` is a readable, integrity-intact training state."""
    try:
        state_payload(path)
        return True
    except (OSError, CheckpointCorruptError):
        return False

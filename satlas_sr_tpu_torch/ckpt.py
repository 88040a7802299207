"""Checkpoint inspector CLI: identify, verify and summarise a checkpoint.

    python -m satlas_sr_tpu_torch.ckpt experiments/run/training_states/30.state
    python -m satlas_sr_tpu_torch.ckpt weights/esrgan_8S2.pth --full
    python -m satlas_sr_tpu_torch.ckpt net_g_30.pth --json

Counterpart of satlas_sr_tpu/ckpt.py for the formats the port reads and
writes:

- reference torch `.pth` (`params`/`params_ema` keys, weights_only load),
  the port's network weights;
- the port's `.state` training states (a torch.save payload behind the
  integrity footer of utils/checkpoint.py): integrity, step, collections,
  per-layer shapes; a torn or flipped file is reported CORRUPT.

The JAX package's `.msgpack`/`.ckpt` files and msgpack `.state`s need a
msgpack reader (ROADMAP queue 1 item 17), its orbax roots the
torch.distributed.checkpoint port (item 14): they are reported UNSUPPORTED.

Exit status: 0 readable + intact, 1 corrupt, unreadable, unsupported or
missing.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .utils.checkpoint import CheckpointCorruptError, state_payload

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's zip container


def _walk_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree, key=str):
            p = f"{prefix}.{k}" if prefix else str(k)
            out.extend(_walk_leaves(tree[k], p))
        return out
    if isinstance(tree, (list, tuple)):  # optimizer param_groups
        out = []
        for i, v in enumerate(tree):
            p = f"{prefix}[{i}]" if prefix else f"[{i}]"
            out.extend(_walk_leaves(v, p))
        return out
    return [(prefix, tree)]


def _leaf_info(v: Any) -> Tuple[Tuple[int, ...], str, int, int]:
    """(shape, dtype, elements, bytes) of a tensor or array leaf."""
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype).removeprefix("torch."), v.numel(),
                v.numel() * v.element_size())
    a = np.asarray(v)
    if a.dtype.kind in "OUS":  # strings/objects are values, not tensors
        raise TypeError(f"non-tensor leaf {a.dtype}")
    return tuple(a.shape), str(a.dtype), int(a.size), int(a.nbytes)


def summarize_tree(tree: Any) -> Dict[str, Any]:
    """Per-top-level-collection tensor/param/byte counts + leaf table."""
    collections: Dict[str, Dict[str, int]] = {}
    leaves = []
    for path, v in _walk_leaves(tree):
        try:
            shape, dtype, size, nbytes = _leaf_info(v)
        except Exception:  # non-array leaf (e.g. a str in a state tree)
            leaves.append({"path": path, "value": repr(v)})
            continue
        top = path.split(".", 1)[0]
        c = collections.setdefault(top, {"tensors": 0, "params": 0, "bytes": 0})
        c["tensors"] += 1
        c["params"] += size
        c["bytes"] += nbytes
        leaves.append({"path": path, "shape": list(shape), "dtype": dtype})
    return {"collections": collections, "leaves": leaves}


def inspect_torch(path: str) -> Dict[str, Any]:
    info: Dict[str, Any] = {"format": "torch-pth", "size_bytes": os.path.getsize(path)}
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        info["status"] = "CORRUPT"
        info["error"] = str(e)
        return info
    info["status"] = "ok"
    if isinstance(state, dict) and any(k in state for k in ("params", "params_ema")):
        info["param_keys"] = sorted(state.keys())
        tree = {k: dict(v.items()) if hasattr(v, "items") else v for k, v in state.items()}
    else:
        info["param_keys"] = []
        tree = state
    info.update(summarize_tree(tree))
    return info


def inspect_state(path: str) -> Dict[str, Any]:
    """A port training state: footer checked, payload read, its `state`
    summarised with the recorded epoch and step."""
    size = os.path.getsize(path)
    info: Dict[str, Any] = {"format": "torch-state", "size_bytes": size, "integrity": "crc-footer"}
    try:
        data = state_payload(path)
    except CheckpointCorruptError as e:
        info["status"] = "CORRUPT"
        info["error"] = str(e)
        return info
    if not data.startswith(_ZIP_MAGIC):
        info.update(format="native-msgpack", status="UNSUPPORTED",
                    error=f"{path}: a JAX-package training state (msgpack); the port has no "
                          "msgpack reader yet (ROADMAP queue 1 item 17)")
        return info
    try:
        blob = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    except Exception as e:
        info["status"] = "CORRUPT"
        info["error"] = f"unreadable checkpoint ({e})"
        return info
    info["status"] = "ok"
    tree = blob
    if isinstance(blob, dict) and "state" in blob:
        info["step"] = int(blob.get("iter", 0))
        info["epoch"] = int(blob.get("epoch", 0))
        tree = blob["state"]
    info.update(summarize_tree(tree))
    return info


def _unsupported(fmt: str, error: str) -> Dict[str, Any]:
    return {"format": fmt, "status": "UNSUPPORTED", "error": error}


def inspect(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        return {"format": "?", "status": "MISSING", "error": path}
    if os.path.isdir(path):
        return _unsupported("orbax-root", f"{path}: orbax checkpoint roots are not yet ported "
                                          "(ROADMAP queue 1 item 14: utils/orbax_io.py becomes "
                                          "torch.distributed.checkpoint)")
    if path.endswith(".pth"):
        return inspect_torch(path)
    if path.endswith((".msgpack", ".ckpt")):
        return _unsupported("native-msgpack", f"{path}: .msgpack/.ckpt weights need a msgpack "
                                              "reader (ROADMAP queue 1 item 17); use a .pth")
    return inspect_state(path)


def _human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def print_report(info: Dict[str, Any], full: bool = False) -> None:
    print(f"format:    {info['format']}")
    print(f"status:    {info['status']}")
    for key in ("error", "integrity", "step", "epoch", "param_keys"):
        if info.get(key) not in (None, [], {}):
            print(f"{key + ':':<11}{info[key]}")
    if "size_bytes" in info:
        print(f"size:      {_human(info['size_bytes'])}")
    for name, c in (info.get("collections") or {}).items():
        print(f"  {name}: {c['tensors']} tensors, {c['params']:,} params, "
              f"{_human(c['bytes'])}")
    if full:
        for leaf in info.get("leaves", []):
            if "shape" in leaf:
                print(f"    {leaf['path']}  {tuple(leaf['shape'])} {leaf['dtype']}")
            else:
                print(f"    {leaf['path']}  {leaf['value']}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("path", help=".pth or .state file")
    parser.add_argument("--full", action="store_true",
                        help="print every tensor (path, shape, dtype)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    info = inspect(args.path)
    if args.json:
        print(json.dumps(info, default=str))
    else:
        print_report(info, full=args.full)
    return 0 if info["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())

"""Checkpoint inspector CLI: identify, verify and summarise a checkpoint.

    python -m satlas_sr_tpu_torch.ckpt experiments/run/training_states/30.state
    python -m satlas_sr_tpu_torch.ckpt weights/esrgan_8S2.pth --full
    python -m satlas_sr_tpu_torch.ckpt net_g_30.pth --json

Counterpart of satlas_sr_tpu/ckpt.py for the formats the port reads and
writes:

- reference torch `.pth` (`params`/`params_ema` keys, weights_only load),
  the port's network weights;
- the JAX package's native `.msgpack`/`.ckpt` weights and its msgpack
  `.state` training states, which the port's trainer also writes and reads
  (utils/msgpack.py): integrity (crc footer, or a legacy footer-less file
  parsed whole), collections, per-layer shapes, the step;
- the port's `.state` training states (a torch.save payload behind the
  same integrity footer): integrity, step, collections, per-layer shapes.
- the port's `train.checkpoint_backend: orbax` roots (`training_states/orbax`,
  torch.distributed.checkpoint steps, utils/orbax_io.py) or one step of
  them: committed steps, the latest step's payload keys and sizes from its
  metadata, and in-flight `*.orbax-checkpoint-tmp-*` directories.
A .state's format is read from its bytes. A torn or flipped file is
reported CORRUPT. A root the JAX package wrote with orbax (tensorstore) is
reported UNSUPPORTED: the port reads the JAX trainer's native .state and
.msgpack files instead.

Exit status: 0 readable + intact, 1 corrupt, unreadable, unsupported or
missing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .utils.checkpoint import CheckpointCorruptError, has_crc_footer, read_state
from .utils.orbax_io import TMP_TAG, committed_steps, is_dcp_step, read_metadata

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


def _steps(info: Dict[str, Any], blob: Any) -> None:
    """The recorded step (a state's `iter`, or a tree's own `step`) and epoch."""
    if not isinstance(blob, dict):
        return
    for key, src in (("step", "iter"), ("step", "step"), ("epoch", "epoch")):
        if key not in info and src in blob:
            try:
                info[key] = int(np.asarray(blob[src]))
            except (TypeError, ValueError):
                pass


def inspect_file(path: str) -> Dict[str, Any]:
    """A native .msgpack/.ckpt, or a .state of either format: read as
    utils/checkpoint.read_state reads it (footer checked, the format told
    by the payload's bytes), the tree summarised."""
    with open(path, "rb") as f:
        blob = f.read()
    info: Dict[str, Any] = {"format": "torch-state" if blob.startswith(_ZIP_MAGIC)
                            else "native-msgpack", "size_bytes": len(blob),
                            "integrity": "crc-footer" if has_crc_footer(blob)
                            else "legacy (no footer)"}
    try:
        fmt, tree = read_state(path)
    except CheckpointCorruptError as e:
        info["status"] = "CORRUPT"
        info["error"] = str(e)
        return info
    info["status"] = "ok"
    _steps(info, tree)
    if fmt == "torch" and isinstance(tree, dict) and "state" in tree:
        tree = tree["state"]  # a msgpack file is summarised whole, as the JAX ckpt does
    info.update(summarize_tree(tree))
    return info


def _unsupported(fmt: str, error: str) -> Dict[str, Any]:
    return {"format": fmt, "status": "UNSUPPORTED", "error": error}


def summarize_dcp(step_dir: str) -> Dict[str, Any]:
    """summarize_tree's collections and leaves of a DCP step, from its metadata."""
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    collections: Dict[str, Dict[str, int]] = {}
    leaves = []
    for key, meta in sorted(read_metadata(step_dir).state_dict_metadata.items()):
        if not isinstance(meta, TensorStorageMetadata):  # a pickled value (ints, lr)
            leaves.append({"path": key, "value": "<object>"})
            continue
        dtype = meta.properties.dtype
        size = int(np.prod(tuple(meta.size), dtype=np.int64))
        c = collections.setdefault(key.split(".", 1)[0], {"tensors": 0, "params": 0, "bytes": 0})
        c["tensors"] += 1
        c["params"] += size
        c["bytes"] += size * dtype.itemsize
        leaves.append({"path": key, "shape": list(meta.size),
                       "dtype": str(dtype).removeprefix("torch.")})
    return {"collections": collections, "leaves": leaves}


def inspect_orbax(path: str) -> Dict[str, Any]:
    """A checkpoint root (or one committed step) of the port's orbax backend."""
    if is_dcp_step(path):  # one step directory
        root, steps = os.path.dirname(os.path.abspath(path)), [os.path.basename(path)]
        step_dirs = [path]
    else:
        root, steps = path, committed_steps(path)
        step_dirs = [os.path.join(root, str(s)) for s in steps]
    foreign = [d for d in step_dirs if not is_dcp_step(d)]
    if foreign:
        return _unsupported("orbax-root", f"{foreign[0]}: not a torch.distributed.checkpoint "
                            "step (an orbax/tensorstore root the JAX package wrote?); the port "
                            "reads the JAX trainer's native .state and .msgpack files instead")
    size = sum(os.path.getsize(os.path.join(d, f)) for d in step_dirs for f in os.listdir(d))
    info: Dict[str, Any] = {
        "format": "dcp-root", "status": "ok" if steps else "empty",
        "committed_steps": [int(s) for s in steps], "size_bytes": size,
        "in_flight": sorted(n for n in os.listdir(root) if TMP_TAG in n)}
    if step_dirs:
        info["step"] = int(os.path.basename(os.path.normpath(step_dirs[-1])))
        info.update(summarize_dcp(step_dirs[-1]))
    return info


def inspect(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        return {"format": "?", "status": "MISSING", "error": path}
    if os.path.isdir(path):
        return inspect_orbax(path)
    if path.endswith(".pth"):
        return inspect_torch(path)
    return inspect_file(path)


def _human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def print_report(info: Dict[str, Any], full: bool = False) -> None:
    print(f"format:    {info['format']}")
    print(f"status:    {info['status']}")
    for key in ("error", "integrity", "step", "epoch", "param_keys", "committed_steps",
                "in_flight"):
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
    parser.add_argument("path", help=".pth, .msgpack/.ckpt or .state file, or an orbax root")
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

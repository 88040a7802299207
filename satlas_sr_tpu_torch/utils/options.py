"""YAML options, with the reference option-file schema (the `options/*.yml` files).

The JAX package's `utils/options.py`, test side, for one process:
`yaml_load`, `--force_yml` nested overrides (no new keys, no exec), test
dataset injection (phase/scale) and the result directory layout under the
port's own root: results/<name>/visualization. `--launcher` other than
`none` raises: multi-process runs come with the multi-GPU slice; the
training options (experiment tree, resume, debug) come with the trainer.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Any, Dict

import yaml


def yaml_load(f: str) -> Dict[str, Any]:
    """Load YAML from a path or a literal string (insertion-ordered dicts)."""
    if os.path.isfile(f):
        with open(f, "r") as fh:
            return yaml.safe_load(fh)
    return yaml.safe_load(f)


def _postprocess_yml_value(value: str) -> Any:
    if value in ("~", "none", "None", "null"):
        return None
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.startswith("["):
        return yaml.safe_load(value)
    return value


# The one optional key the test path reads with a default that --force_yml may
# create; any other new key is refused as a likely typo.
_FORCE_YML_CREATABLE = {"compute_dtype"}


def apply_force_yml(opt: Dict[str, Any], entries) -> None:
    """Apply `a:b:c=value` overrides in place (no new keys created, except
    those in _FORCE_YML_CREATABLE)."""
    for entry in entries or []:
        keys, value = entry.split("=", 1)
        keys = keys.strip().split(":")
        node = opt
        for k in keys[:-1]:
            node = node[k]
        path = ":".join(keys)
        if keys[-1] not in node and path not in _FORCE_YML_CREATABLE:
            raise KeyError(f"--force_yml cannot create new key {path}")
        node[keys[-1]] = _postprocess_yml_value(value.strip())


def parse_options(root_path: str, is_train: bool = False, argv=None):
    if is_train:
        raise NotImplementedError(
            "training options: the trainer is not yet ported (ROADMAP queue 1 items 9-11)")
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm", "jax"], default="none",
                        help="job launcher; only 'none' (one process) is ported")
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="Override yml entries, e.g. compute_dtype=float32")
    args = parser.parse_args(argv)
    if args.launcher != "none":
        raise NotImplementedError(
            f"--launcher {args.launcher}: multi-GPU not yet ported (ROADMAP queue 1 item 14)")

    opt = yaml_load(args.opt)
    opt["rank"], opt["world_size"] = 0, 1
    apply_force_yml(opt, args.force_yml)

    if opt.get("manual_seed") is None:  # seeds a model built without weights
        opt["manual_seed"] = random.randint(1, 10000)
    opt["is_train"] = False

    for _, dataset in (opt.get("test_datasets") or {}).items():
        dataset.setdefault("phase", "test")
        if "scale" in opt:
            dataset.setdefault("scale", opt["scale"])

    path_opt = opt.setdefault("path", {})
    for key, val in list(path_opt.items()):
        if val is not None and "pretrain_network" in key:
            path_opt[key] = os.path.expanduser(val)

    results_root = os.path.join(
        path_opt.get("results_root") or os.path.join(root_path, "results"), opt["name"])
    path_opt["results_root"] = results_root
    path_opt["log"] = results_root
    path_opt["visualization"] = os.path.join(results_root, "visualization")
    return opt, args


def make_exp_dirs(opt: Dict[str, Any]) -> None:
    """Create the result directory tree."""
    for key in ("results_root", "visualization"):
        os.makedirs(opt["path"][key], exist_ok=True)


def dict2str(opt: Dict[str, Any], indent_level: int = 1) -> str:
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + f"{k}: {v}\n"
    return msg

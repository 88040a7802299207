"""YAML options, with the reference option-file schema (the `options/*.yml` files).

The JAX package's `utils/options.py`: `yaml_load`, `--force_yml` nested
overrides (no new keys but the optional ones below, no exec), dataset
injection (phase/scale), `--auto_resume`, `--debug` (a `debug_` name and
short frequencies), `seed_with_rank`, and the directory layouts:
experiments/<name>/{models,training_states,visualization} for training,
results/<name>/visualization for testing.

`--launcher pytorch|jax|slurm` runs the process as one rank of a
torch.distributed group (`init_distributed`; NCCL on the card, gloo on the
CPU, `--device cpu`): `rank`, `world_size`, `dist` and `seed_with_rank =
manual_seed + rank` land in the options, and `make_exp_dirs` archives on
rank 0 while the peers wait at a barrier. `local_world_size` is the ranks
on this host (LOCAL_WORLD_SIZE, or SLURM's tasks per node).
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, Tuple

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


# Optional keys the port reads with a default that --force_yml may create;
# any other new key is refused as a likely typo.
_FORCE_YML_CREATABLE = {"compute_dtype", "train:accum_steps", "network_g:remat"}


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


def _slurm_env() -> None:
    """torchrun's variables from SLURM's (basicsr's init_dist('slurm'))."""
    missing = [k for k in ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--launcher slurm outside a SLURM step: {', '.join(missing)} unset")
    os.environ["RANK"] = os.environ["SLURM_PROCID"]
    os.environ["WORLD_SIZE"] = os.environ["SLURM_NTASKS"]
    os.environ["LOCAL_RANK"] = os.environ["SLURM_LOCALID"]
    if "MASTER_ADDR" not in os.environ:
        nodes = subprocess.run(["scontrol", "show", "hostname", os.environ["SLURM_NODELIST"]],
                               capture_output=True, text=True, check=True).stdout
        os.environ["MASTER_ADDR"] = nodes.split()[0]
    os.environ.setdefault("MASTER_PORT", "29500")


def local_world_size(default: int = 1) -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE as torchrun sets it, else SLURM's
    tasks per node (SLURM_NTASKS_PER_NODE, or the first count of
    SLURM_TASKS_PER_NODE's "4(x2),2"), else `default`. The space layout
    (parallel/mesh.mesh_2d), infer_grid's default split and doctor read it."""
    value = (os.environ.get("LOCAL_WORLD_SIZE") or os.environ.get("SLURM_NTASKS_PER_NODE")
             or os.environ.get("SLURM_TASKS_PER_NODE", "").split("(")[0].split(",")[0])
    return int(value) if value else int(default)


def init_distributed(launcher: str, device="cuda") -> Tuple[int, int]:
    """(rank, world_size) of this process; 'none' is one process.

    'pytorch' and 'jax' read torchrun's env:// variables (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT), 'slurm' maps SLURM's onto them.
    The backend is NCCL for a card (which becomes the current device) and
    gloo on the CPU. A group the caller initialised first is taken as it
    is. Any other failure raises: a rank that silently stayed single would
    rerun the whole corpus and race its peers on the same output paths.
    """
    import torch.distributed as dist

    from ..device import resolve_device

    if launcher == "none":
        return 0, 1
    if not dist.is_initialized():
        if launcher == "slurm":
            _slurm_env()
        dev = resolve_device(device)  # after LOCAL_RANK is known
        if dev.type == "cuda":
            import torch

            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def close_distributed() -> None:
    """Destroy the process group at a CLI's exit, if one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def parse_options(root_path: str, is_train: bool = False, argv=None, device="cuda"):
    """(opt, args); `--device` on the command line overrides `device`."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm", "jax"], default="none",
                        help="job launcher: pytorch/jax read torchrun's env://, slurm SLURM's")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--local-rank", type=int, default=0)  # accepted, unused (LOCAL_RANK)
    parser.add_argument("--device", default=None,
                        help=f"torch device (default: {device}; cpu runs the ranks on gloo)")
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="Override yml entries, e.g. train:ema_decay=0.999")
    args = parser.parse_args(argv)
    args.device = args.device or device

    opt = yaml_load(args.opt)
    opt["dist"] = args.launcher != "none"
    opt["rank"], opt["world_size"] = init_distributed(args.launcher, args.device)
    # overrides first: `--force_yml manual_seed=N` must feed seed_with_rank
    apply_force_yml(opt, args.force_yml)

    if opt.get("manual_seed") is None:
        # one draw for the job: the replicas' initial weights come from it
        from ..parallel.mesh import broadcast_bytes

        seed = str(random.randint(1, 10000)).encode()
        opt["manual_seed"] = int(broadcast_bytes(seed) if opt["world_size"] > 1 else seed)
    opt["seed_with_rank"] = opt["manual_seed"] + opt["rank"]
    opt["auto_resume"] = args.auto_resume
    opt["is_train"] = is_train
    if args.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]
    if opt.get("num_gpu") == "auto":
        opt["num_gpu"] = 1  # one card a process

    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset.setdefault("phase", phase.split("_")[0])
        if "scale" in opt:
            dataset["scale"] = opt["scale"]
    for _, dataset in (opt.get("test_datasets") or {}).items():
        dataset.setdefault("phase", "test")
        if "scale" in opt:
            dataset.setdefault("scale", opt["scale"])

    path_opt = opt.setdefault("path", {})
    for key, val in list(path_opt.items()):
        if val is not None and ("resume_state" in key or "pretrain_network" in key):
            path_opt[key] = os.path.expanduser(val)

    if is_train:
        root = os.path.join(path_opt.get("experiments_root")
                            or os.path.join(root_path, "experiments"), opt["name"])
        path_opt["experiments_root"] = root
        path_opt["models"] = os.path.join(root, "models")
        path_opt["training_states"] = os.path.join(root, "training_states")
        path_opt["log"] = root
        path_opt["visualization"] = os.path.join(root, "visualization")
        if "debug" in opt["name"]:
            if opt.get("val") is not None:
                opt["val"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = os.path.join(
            path_opt.get("results_root") or os.path.join(root_path, "results"), opt["name"])
        path_opt["results_root"] = results_root
        path_opt["log"] = results_root
        path_opt["visualization"] = os.path.join(results_root, "visualization")
    return opt, args


def make_exp_dirs(opt: Dict[str, Any], archive_existing: bool = False) -> None:
    """Create the experiment (training) or result (testing) directory tree.

    With archive_existing (a fresh, non-resumed training run) an existing
    experiment directory is first renamed to <name>_archived_<timestamp>,
    basicsr's mkdir_and_rename; debug runs reuse theirs. Rank 0 renames;
    the peers wait at a barrier, so none creates the new tree before (or
    while) the old one moves away.
    """
    from ..parallel.mesh import barrier, is_main_process

    path_opt = opt["path"]
    if opt.get("is_train"):
        root = path_opt["experiments_root"]
        if archive_existing and "debug" not in opt["name"]:
            if is_main_process() and os.path.isdir(root):
                archived = f"{root}_archived_{time.strftime('%Y%m%d_%H%M%S')}"
                if os.path.exists(archived):  # a rerun within the same second
                    archived = f"{archived}_{os.getpid()}"
                print(f"Experiment dir {root} exists: archiving to {archived}", flush=True)
                os.rename(root, archived)
            barrier()
        keys = ("experiments_root", "models", "training_states", "visualization")
    else:
        keys = ("results_root", "visualization")
    for key in keys:
        os.makedirs(path_opt[key], exist_ok=True)


def copy_opt_file(opt_path: str, dest_dir: str) -> None:
    """Copy the option file into the experiment, with the run's time and argv."""
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, os.path.basename(opt_path))
    shutil.copyfile(opt_path, dest)
    with open(dest, "a") as f:
        f.write(f"\n# Run: {time.strftime('%Y-%m-%d %H:%M:%S')} argv: {' '.join(sys.argv)}\n")


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

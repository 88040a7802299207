"""Config linting: typo detection over the option-YAML schema.

The reference silently ignores unknown YAML keys — a misspelled
`ema_decay` trains a different model with no signal anywhere (basicsr
reads every key with dict.get). `--force_yml` already refuses to create
new keys; this extends the same protection to the YAML file itself:
every section is checked against the key vocabulary documented in
docs/CONFIG_REFERENCE.md, and unknown keys produce WARNINGS (never
errors — forward compatibility) with a did-you-mean suggestion.

Keys the reference schema carries but this framework deliberately does
not read (`dist_params`, `io_backend`, `pbar`, `ldl_opt`) are accepted
silently so every shipped reference config lints clean.

A copy of the JAX package's satlas_sr_tpu/utils/lint.py (pure Python, no
JAX): the two packages read one option schema, and tests hold their
warnings equal on every shipped config.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, List, Optional

# ----------------------------------------------------------------- vocabulary

# Known-but-unread keys (reference schema parity); never warned about.
_IGNORED = object()

_DATASET = {
    "name": None, "type": None, "sentinel2_path": None, "naip_path": None,
    "n_s2_images": None, "s2_bands": None, "use_3d": None, "rand_crop": None,
    "old_naip_path": None, "osm_objs_path": None, "n_osm_objs": None,
    "tile_weights": None, "train_samples": None, "batch_size_per_gpu": None,
    "num_worker_per_gpu": None, "use_shuffle": None,
    "dataset_enlarge_ratio": None, "prefetch_depth": None,
    "batch_size": None,  # val/test eval-loader batch (train.py, test.py)
    "phase": None, "scale": None,
    "io_backend": _IGNORED,
}

_METRIC = {
    "type": None, "better": None, "crop_border": None, "test_y_channel": None,
    "input_order": None, "max_offset": None, "lpips_model": None,
    "lpips_weights_path": None, "clip_model": None, "clip_weights_path": None,
}

_OPTIM = {"type": None, "lr": None, "betas": None, "weight_decay": None,
          "momentum": None}

_SCHEDULER = {"type": None, "milestones": None, "gamma": None,
              "restarts": None, "restart_weights": None}

_TRAIN = {
    "total_iter": None, "warmup_iter": None, "ema_decay": None,
    "net_d_iters": None, "net_d_init_iters": None,
    "optim_g": _OPTIM, "optim_d": _OPTIM, "scheduler": _SCHEDULER,
    "pixel_opt": {"type": None, "loss_weight": None, "reduction": None},
    "perceptual_opt": {
        "type": None, "layer_weights": {"*": None}, "vgg_type": None,
        "use_input_norm": None, "range_norm": None, "perceptual_weight": None,
        "style_weight": None, "criterion": None, "vgg_weights_path": None,
    },
    "gan_opt": {"type": None, "gan_type": None, "real_label_val": None,
                "fake_label_val": None, "loss_weight": None},
    "ssim_opt": {"type": None, "loss_weight": None},
    "clip_opt": {"type": None, "clip_loss_model": None, "loss_weight": None,
                 "clip_weights_path": None},
    "ldl_opt": _IGNORED,
    "accum_steps": None, "checkpoint_backend": None, "async_checkpoint": None,
}

_VAL = {"val_freq": None, "save_img": None, "fast_metrics": None,
        "metrics": {"*": _METRIC}, "pbar": _IGNORED}

_TEST = {"save_img": None, "fast_metrics": None, "metrics": {"*": _METRIC}}

_LOGGER = {
    "print_freq": None, "save_checkpoint_freq": None, "use_tb_logger": None,
    "save_pth": None,
    "wandb": {"project": None, "resume_id": None, "sync_tensorboard": None},
    "profile": {"start_iter": None, "num_iters": None, "dir": None},
}

_PATH = {
    "pretrain_network_g": None, "pretrain_network_d": None,
    "param_key_g": None, "param_key_d": None,
    "strict_load_g": None, "strict_load_d": None, "resume_state": None,
    "experiments_root": None, "results_root": None,
    # derived by parse_options; present when linting a parsed dict
    "models": None, "training_states": None, "log": None,
    "visualization": None,
    "ignore_resume_networks": _IGNORED,
}

_NETWORK_G_COMMON = {"type": None}
_NETWORK_G_BY_TYPE = {
    "SSR_RRDBNet": {
        "num_in_ch": None, "num_out_ch": None, "scale": None,
        "num_feat": None, "num_block": None, "num_grow_ch": None,
        "remat": None, "trunk_unroll": None, "rdb_impl": None,
        "rdb_tile": None, "fused": None, "output_size": None,
    },
    "SRCNN": {
        "in_channels": None, "mask_channels": None, "revisits": None,
        "hidden_channels": None, "out_channels": None, "kernel_size": None,
        "residual_layers": None, "output_size": None, "zoom_factor": None,
        "sr_kernel_size": None,
    },
}
_NETWORK_G_BY_TYPE["HighResNet"] = dict(
    _NETWORK_G_BY_TYPE["SRCNN"], skip_paddings=None
)

_NETWORK_D = {"type": None, "num_in_ch": None, "num_feat": None,
              "skip_connection": None}

# Injected by parse_options / the CLIs — never user typos.
_INJECTED = {"dist": None, "rank": None, "world_size": None, "is_train": None,
             "auto_resume": None, "seed_with_rank": None, "root_path": None}

_TOP_TRAIN = {
    "name": None, "model_type": None, "scale": None, "num_gpu": None,
    "manual_seed": None,
    "l1_gt_usm": None, "percep_gt_usm": None, "gan_gt_usm": None,
    "feed_disc_lr": None, "osm_obj_weight": None, "n_osm_objs": None,
    "compute_dtype": None, "matmul_precision": None, "spatial_shards": None,
    "datasets": {"*": _DATASET}, "test_datasets": {"*": _DATASET},
    "network_g": None,  # handled specially (per-type vocabulary)
    "network_d": _NETWORK_D,
    "path": _PATH, "train": _TRAIN, "val": _VAL, "test": _TEST,
    "logger": _LOGGER,
    "dist_params": _IGNORED,
    **_INJECTED,
}

_TOP_INFER = {
    "name": None, "model_type": None, "data_dir": None, "save_path": None,
    "n_lr_images": None, "s2_bands": None,
    "batch_size": None, "grid_size": None, "whole_tile": None, "halo": None,
    "halo_window": None, "spatial_shards": None, "decode_prefetch": None,
    "skip_existing": None,
    "manual_seed": None, "scale": None, "num_gpu": None,
    "compute_dtype": None, "matmul_precision": None,
    "network_g": None, "path": _PATH,
    "dist_params": _IGNORED,
    **_INJECTED,
}

# Cheap enum checks — wrong VALUES that would otherwise fail late or silently.
_ENUMS = {
    "model_type": {"SSRESRGANModel", "L2Model", "OSMObjESRGANModel"},
    "train.scheduler.type": {"MultiStepLR", "MultiStepRestartLR"},
    "train.checkpoint_backend": {"native", "orbax"},
    "train.gan_opt.gan_type": {"vanilla", "lsgan", "wgan", "hinge"},
    "compute_dtype": {"float32", "bfloat16", "bf16", "f32"},
    "network_d.type": {"SSR_UNetDiscriminatorSN", "OSMObjDiscriminator"},
}

def _suggest(key: str, vocab) -> str:
    hits = difflib.get_close_matches(key, [v for v in vocab if v != "*"], 1)
    return f" (did you mean {hits[0]!r}?)" if hits else ""


def _walk(node: Any, spec: Optional[Dict[str, Any]], path: str,
          out: List[str]) -> None:
    if spec is None or spec is _IGNORED or not isinstance(node, dict):
        return
    wildcard = spec.get("*", "__absent__")
    for key, value in node.items():
        here = f"{path}{key}"
        if key in spec:
            sub = spec[key]
        elif wildcard != "__absent__":
            sub = wildcard
        else:
            out.append(f"unknown config key '{here}'{_suggest(key, spec)}")
            continue
        if isinstance(sub, dict) or sub is _IGNORED:
            _walk(value, sub if isinstance(sub, dict) else _IGNORED,
                  f"{here}:", out)
        enum = _ENUMS.get(here.replace(":", "."))
        if enum is not None and isinstance(value, str) and value not in enum:
            out.append(
                f"'{here}' value {value!r} is not one of {sorted(enum)}"
                f"{_suggest(value, enum)}"
            )


def _lint_network_g(block: Any, out: List[str]) -> None:
    if not isinstance(block, dict):
        return
    g_type = block.get("type")
    fields = _NETWORK_G_BY_TYPE.get(g_type)
    if g_type is not None and fields is None:
        out.append(
            f"'network_g:type' value {g_type!r} is not a known generator"
            f"{_suggest(str(g_type), _NETWORK_G_BY_TYPE)}"
        )
        return  # cannot check fields without a vocabulary
    spec = dict(_NETWORK_G_COMMON, **(fields or {}))
    _walk(block, spec, "network_g:", out)


def lint_options(opt: Dict[str, Any], kind: str = "train") -> List[str]:
    """Return warning strings for unknown keys / bad enum values.

    kind: 'train' (train/test CLIs — the full experiment schema) or
    'infer' (infer/infer_grid/serve/export configs). Never raises on
    config content; unknown keys are warnings by design.
    """
    spec = dict(_TOP_TRAIN if kind == "train" else _TOP_INFER)
    out: List[str] = []
    _walk(opt, spec, "", out)
    _lint_network_g(opt.get("network_g"), out)
    return out


def report_lint(opt: Dict[str, Any], kind: str = "train",
                rank: int = 0) -> List[str]:
    """Print lint warnings (rank 0 only) and return them."""
    warnings = lint_options(opt, kind)
    if rank == 0:
        for w in warnings:
            print(f"[config lint] WARNING: {w}", flush=True)
    return warnings

"""Preflight diagnostics CLI: validate a config and the card before a run.

    python -m satlas_sr_tpu_torch.doctor -opt options/esrgan_s2naip_urban.yml
    python -m satlas_sr_tpu_torch.doctor -opt cfg.yml --device cpu

Counterpart of satlas_sr_tpu/doctor.py. Checks:

- config lint: unknown keys / bad enum values, with did-you-mean
  (utils/lint.py, the warnings the CLIs print at startup),
- filesystem: dataset roots, pretrained checkpoints, resume state, OSM json
  and tile weights exist and are non-empty,
- consistency: network_g.num_in_ch against n_s2_images (the reference ships
  stale 36-channel values), n_lr_images for infer configs,
- towers: which perceptual/CLIP/LPIPS weights resolve (config key, env var,
  or none: a seeded random tower and `(untrained-tower)` tags); a CLIP or
  LPIPS file that is present is also loaded (metrics/clipscore and
  metrics/lpips `tower_pretrained`), so an unmappable file is an error here
  and not an hour into a run,
- parallelism: the launcher's variables (torchrun's RANK, WORLD_SIZE,
  LOCAL_RANK, MASTER_ADDR/PORT, or SLURM's), the world size, LOCAL_RANK
  against the card count, the process-group backend `--launcher` would
  choose (NCCL on the card, gloo on the CPU), and the checkpoint backend
  (native .state, or `orbax`: torch.distributed.checkpoint steps),
- runtime, on the card: the CUDA device count (probed in a daemon thread
  with a timeout) and the card's name against num_gpu, `spatial_shards`
  (a tile's rows over a space group of ranks: it must divide the ranks on
  this host, LOCAL_WORLD_SIZE, so that no group spans hosts), the
  port's PNG codec or the PIL fallback, and in place of the JAX package's
  compile cache the kernel build: nvcc found, build/torch_kernels
  writable, and whether the RDB library of the current source is built or
  builds at first use. With `--device cpu` the devices row says so and
  nothing about CUDA is checked.

Exit status: 1 if any ERROR (a run would fail or silently mis-train), a
missing card or nvcc included; else 0. `--strict` also fails on warnings.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Tuple

from .utils.lint import lint_options
from .utils.options import local_world_size, yaml_load

OK, WARN, ERR = "ok", "WARNING", "ERROR"


class Report:
    def __init__(self) -> None:
        self.rows: List[Tuple[str, str, str]] = []
        self.fetchable: List[str] = []  # registry artifacts for missing files

    def add(self, level: str, area: str, msg: str) -> None:
        self.rows.append((level, area, msg))

    def emit(self) -> Tuple[int, int]:
        width = max((len(a) for _, a, _ in self.rows), default=0)
        for level, area, msg in self.rows:
            tag = {OK: "  ok  ", WARN: " WARN ", ERR: "ERROR "}[level]
            print(f"[{tag}] {area:<{width}}  {msg}")
        if self.fetchable:
            names = " ".join(dict.fromkeys(self.fetchable))  # dedup, ordered
            print(f"\nhint: missing artifact(s) are downloadable: "
                  f"python -m satlas_sr_tpu_torch.fetch get {names} --dest <dir>")
        errors = sum(1 for lv, _, _ in self.rows if lv == ERR)
        warns = sum(1 for lv, _, _ in self.rows if lv == WARN)
        return errors, warns


def _fetch_artifact_for(area: str, path: str) -> str:
    """Map a missing config path to a fetch-registry artifact name, if any
    (the registry mirrors the reference README's Download tables)."""
    from .fetch import REGISTRY

    stem = os.path.basename(path)
    for suffix in (".pth", ".tar", ".json"):
        stem = stem.removesuffix(suffix)
    if stem in REGISTRY:  # e.g. pretrain_network_g: weights/esrgan_8S2.pth
        return stem
    aliases = {"srcnn_s2naip": "srcnn", "highresnet_s2naip": "highresnet"}
    if stem in aliases:
        return aliases[stem]
    if area.endswith(".tile_weights"):
        return "train_tile_weights"
    if area.endswith(".osm_objs_path"):
        return "osm_chips_to_masks"
    # dataset roots: .../{set_name}/{naip|sentinel2}
    for part in os.path.normpath(path).split(os.sep):
        if part in ("train_urban_set", "train_full_set", "val_set",
                    "small_val_set", "test_set", "old_naip"):
            return part
    return ""


def _check_file(rep: Report, area: str, path: Any, required: bool) -> None:
    if not path:
        return
    path = os.path.expanduser(str(path))
    if not os.path.exists(path):
        rep.add(ERR if required else WARN, area, f"missing: {path}")
        artifact = _fetch_artifact_for(area, path)
        if artifact:
            rep.fetchable.append(artifact)
    elif os.path.isfile(path) and os.path.getsize(path) == 0:
        rep.add(ERR, area, f"empty file: {path}")
    else:
        rep.add(OK, area, path)


def _check_config(rep: Report, opt: Dict[str, Any], kind: str) -> None:
    warnings = lint_options(opt, kind)
    for w in warnings:
        rep.add(WARN, "config", w)
    if not warnings:
        rep.add(OK, "config", "no unknown keys")

    # f32 is the strict-parity option; the shipped ESRGAN configs train in
    # bfloat16 (a pointer), the L2 ones in float32, where the card measured
    # bfloat16 off float32's trajectory (a warning to keep it).
    dtype = str(opt.get("compute_dtype", "float32")).lower()
    if kind == "train" and dtype in ("float32", "f32"):
        if str(opt.get("model_type", "")) == "L2Model":
            rep.add(WARN, "perf",
                    "compute_dtype: float32, the shipped default for the L2 family; keep it: "
                    "bfloat16 is not equivalent on the card (final val PSNR 0.490 dB from "
                    "float32's after 300 iterations of dtype_train_equiv --family l2, the same "
                    "in three runs that repeat bit for bit, over its 0.05 dB bar; NVIDIA H100 "
                    "80GB HBM3, 700 W)")
        else:
            rep.add(OK, "perf",
                    "compute_dtype: float32 (strict parity); the shipped ESRGAN configs "
                    "train in bfloat16 (PERF.md has the card's rates in both dtypes)")

    path_opt = opt.get("path") or {}
    _check_file(rep, "path.pretrain_network_g",
                path_opt.get("pretrain_network_g"), required=True)
    _check_file(rep, "path.pretrain_network_d",
                path_opt.get("pretrain_network_d"), required=True)
    _check_file(rep, "path.resume_state", path_opt.get("resume_state"),
                required=True)

    if kind == "infer":
        from .utils.infer_utils import channels_per_frame

        _check_file(rep, "data_dir", opt.get("data_dir"), required=True)
        n_lr = opt.get("n_lr_images")
        num_in = (opt.get("network_g") or {}).get("num_in_ch")
        c = channels_per_frame(opt.get("s2_bands"))
        if n_lr and num_in and int(num_in) != c * int(n_lr):
            rep.add(ERR, "consistency",
                    f"network_g.num_in_ch={num_in} but n_lr_images={n_lr} "
                    f"stacks {c * int(n_lr)} channels"
                    + (f" with s2_bands={opt['s2_bands']}"
                       if opt.get("s2_bands") else ""))
        return

    for section in ("datasets", "test_datasets"):
        for name, ds in (opt.get(section) or {}).items():
            area = f"{section}.{name}"
            for key in ("sentinel2_path", "naip_path", "osm_objs_path", "tile_weights",
                        "old_naip_path"):
                _check_file(rep, f"{area}.{key}", ds.get(key), required=True)
            n_s2 = ds.get("n_s2_images")
            num_in = (opt.get("network_g") or {}).get("num_in_ch")
            if (name == "train" and n_s2 and num_in and not ds.get("use_3d")
                    and int(num_in) != 3 * int(n_s2)):
                rep.add(WARN, "consistency",
                        f"network_g.num_in_ch={num_in} vs n_s2_images={n_s2} "
                        f"(={3 * int(n_s2)} channels) — the trainer corrects "
                        f"this with a warning, as for the reference's stale "
                        f"36-channel configs")


def _tower_source(cfg_path: Any, env_var: str) -> Tuple[str, str]:
    """(description, path) of where a tower's weights come from."""
    if cfg_path:
        p = os.path.expanduser(str(cfg_path))
        return (f"config path {p}" if os.path.exists(p) else f"MISSING config path {p}"), p
    env = os.environ.get(env_var)
    if env:
        return (f"env {env_var}={env}" if os.path.exists(env)
                else f"MISSING env {env_var}={env}"), env
    return "", ""


def _tower_loads(metric: Dict[str, Any], path: str) -> str:
    """'' when the CLIP/LPIPS metric's weights file loads as a pretrained
    tower, else why not."""
    from .metrics import clipscore, lpips

    try:
        if metric["type"] == "calculate_clipscore":
            ok = clipscore.tower_pretrained(metric.get("clip_model"), path)
        else:
            ok = lpips.tower_pretrained(metric.get("lpips_model", "vgg"), path)
    except Exception as e:  # an unmappable file raises TowerImportError
        return f"{type(e).__name__}: {e}"
    return "" if ok else "not loadable as a pretrained tower"


def _check_towers(rep: Report, opt: Dict[str, Any]) -> None:
    train_opt = opt.get("train") or {}
    wants = []
    if train_opt.get("perceptual_opt"):
        wants.append(("perceptual VGG19",
                      train_opt["perceptual_opt"].get("vgg_weights_path"),
                      "SSR_TPU_VGG19_WEIGHTS", None))
    if train_opt.get("clip_opt"):
        wants.append(("CLIP loss tower",
                      train_opt["clip_opt"].get("clip_weights_path"),
                      "SSR_TPU_CLIP_WEIGHTS", None))
    for section in ("val", "test"):
        for mname, m in ((opt.get(section) or {}).get("metrics") or {}).items():
            t = (m or {}).get("type")
            if t == "calculate_lpips":
                wants.append((f"{section}.metrics.{mname} LPIPS",
                              m.get("lpips_weights_path"), "SSR_TPU_LPIPS_WEIGHTS", m))
            elif t == "calculate_clipscore":
                wants.append((f"{section}.metrics.{mname} CLIPScore",
                              m.get("clip_weights_path"), "SSR_TPU_CLIP_WEIGHTS", m))
    for label, cfg_path, env_var, metric in wants:
        src, path = _tower_source(cfg_path, env_var)
        if not src:
            rep.add(WARN, "towers",
                    f"{label}: no weights configured ({env_var} unset) — "
                    f"runs as a seeded random tower, tagged (untrained-tower)")
        elif src.startswith("MISSING"):
            rep.add(ERR, "towers", f"{label}: {src}")
        elif metric is not None and (why := _tower_loads(metric, path)):
            rep.add(ERR, "towers", f"{label}: {src}: {why}")
        else:
            rep.add(OK, "towers", f"{label}: {src}")


def _devices_with_timeout(timeout_s: float) -> Dict[str, Any]:
    """The CUDA device count and the first card's name, probed in a daemon
    thread: a wedged driver must be reported, not hang the doctor."""
    import threading

    box: Dict[str, Any] = {}

    def probe() -> None:
        try:
            import torch

            box["count"] = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if box["count"]:
                box["name"] = torch.cuda.get_device_name(0)
        except Exception as e:  # noqa: BLE001 - report, never raise
            box["error"] = e

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        box["timeout"] = True
    return box


def _check_kernel_build(rep: Report) -> None:
    """nvcc, a writable build/torch_kernels, and the RDB library's state."""
    from .ops.cuda import build

    try:
        nvcc = build.nvcc()
        if not os.path.exists(nvcc):
            raise RuntimeError(f"{nvcc} does not exist")
        rep.add(OK, "kernel build", f"nvcc: {nvcc}")
    except Exception as e:
        rep.add(ERR, "kernel build", f"no nvcc ({e}): the RDB kernel cannot build")
    try:
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        probe = build.BUILD_DIR / f".doctor_probe{os.getpid()}"
        probe.write_text("ok")
        probe.unlink()
        rep.add(OK, "kernel build", f"writable: {build.BUILD_DIR}")
    except OSError as e:
        rep.add(ERR, "kernel build", f"{build.BUILD_DIR} not writable ({e})")
    lib = build.library_path("rdb")
    rep.add(OK, "kernel build", f"rdb built: {lib}" if lib.exists()
            else f"rdb not built for this source: builds at first use into {lib}")


def _check_parallel(rep: Report, opt: Dict[str, Any], device: str, cards: int) -> None:
    """The launcher's variables, the world size, LOCAL_RANK against the
    cards, the backend --launcher would choose, and the checkpoint backend."""
    env = os.environ
    if "SLURM_PROCID" in env and "RANK" not in env:
        rank, world = env["SLURM_PROCID"], env.get("SLURM_NTASKS", "?")
        local, source = env.get("SLURM_LOCALID", "0"), "slurm (--launcher slurm)"
    else:
        rank, world = env.get("RANK", "0"), env.get("WORLD_SIZE", "1")
        local, source = env.get("LOCAL_RANK", "0"), "env:// (--launcher pytorch)"
    backend = "gloo" if device == "cpu" else "nccl"
    if "RANK" in env or "SLURM_PROCID" in env:
        addr = f"{env.get('MASTER_ADDR', '?')}:{env.get('MASTER_PORT', '?')}"
        rep.add(OK, "parallel", f"{source}: rank {rank} of {world}, LOCAL_RANK {local}, "
                                f"master {addr}, backend {backend}")
    else:
        rep.add(OK, "parallel", f"one process (no RANK/WORLD_SIZE set; under torchrun "
                                f"--launcher pytorch runs data-parallel ranks on {backend})")
    if device != "cpu" and cards and int(local) >= cards:
        rep.add(ERR, "parallel", f"LOCAL_RANK={local} but {cards} card(s): this rank has no "
                                 "card (the entry points raise)")
    ckpt = str((opt.get("train") or {}).get("checkpoint_backend") or "native")
    if "data_dir" not in opt:
        rep.add(OK, "checkpoints", "orbax: torch.distributed.checkpoint steps under "
                                   "training_states/orbax (async, atomic commits)"
                if ckpt == "orbax" else "native: training_states/*.state (crc footer)")


def _check_spatial(rep: Report, opt: Dict[str, Any]) -> None:
    """`spatial_shards` against the ranks: a space group is S consecutive
    ranks and must lie on one host (parallel/mesh.mesh_2d refuses otherwise)."""
    sp = int(opt.get("spatial_shards", 1) or 1)
    if sp <= 1:
        return
    env = os.environ
    world = int(env.get("WORLD_SIZE") or env.get("SLURM_NTASKS") or 1)
    local = local_world_size(world)
    if local % sp and world <= local:
        rep.add(ERR, "devices", f"spatial_shards={sp} does not divide the {local} rank(s) on this "
                                "host: start that many ranks a group (torchrun --nproc_per_node, "
                                "--launcher pytorch); infer_grid raises")
    elif local % sp:
        rep.add(ERR, "devices", f"spatial_shards={sp}: a space group would span hosts ({local} "
                                f"rank(s) a host, {world} in all); spatial sharding needs each "
                                "group on one host")
    else:
        rep.add(OK, "devices", f"spatial_shards={sp}: a tile's rows split over {sp} ranks of "
                               f"this host's {local}, halo exchange between them")


def _check_runtime(rep: Report, opt: Dict[str, Any], device: str = "cuda",
                   device_timeout_s: float = 60.0) -> None:
    if device == "cpu":
        rep.add(OK, "devices", "cpu (as asked: CUDA not checked)")
    else:
        box = _devices_with_timeout(device_timeout_s)
        count = box.get("count", 0)
        if box.get("timeout"):
            rep.add(ERR, "devices", f"CUDA did not answer within {device_timeout_s:.0f}s "
                                    f"(runs would block the same way)")
        elif "error" in box:
            rep.add(ERR, "devices", f"CUDA failed to initialise: {box['error']}")
        elif not count:
            rep.add(ERR, "devices", "no CUDA device: the entry points raise without a card "
                                    "(pass --device cpu to run on the CPU)")
        else:
            rep.add(OK, "devices", f"{count} x cuda: {box['name']}")
        num_gpu = opt.get("num_gpu")
        if count and isinstance(num_gpu, int) and num_gpu > count:
            rep.add(WARN, "devices", f"num_gpu={num_gpu} but only {count} local devices")
    _check_parallel(rep, opt, device, 0 if device == "cpu" else count)
    _check_spatial(rep, opt)

    from .utils import imgio, native_png

    if native_png.available():
        rep.add(OK, "native png", f"{imgio.codec()}: the port's zlib codec "
                                  f"({native_png.loaded_path()})")
    else:
        rep.add(WARN, "native png", f"{imgio.codec()}: the port's codec did not build "
                                    f"(zlib.h present: {native_png.zlib_present()}); "
                                    f"PIL fallback (slower host path)")
    if device != "cpu":
        _check_kernel_build(rep)


def diagnose(opt: Dict[str, Any], check_runtime: bool = True, device: str = "cuda") -> Report:
    """Every check's rows for one config."""
    kind = "infer" if "data_dir" in opt else "train"
    rep = Report()
    rep.add(OK, "schema", f"linting as a {kind} config")
    _check_config(rep, opt, kind)
    _check_towers(rep, opt)
    if check_runtime:
        _check_runtime(rep, opt, device)
    return rep


def run_doctor(opt: Dict[str, Any], strict: bool = False, check_runtime: bool = True,
               device: str = "cuda") -> int:
    errors, warns = diagnose(opt, check_runtime, device).emit()
    weights = (opt.get("path") or {}).get("pretrain_network_g")
    if weights and os.path.isfile(os.path.expanduser(str(weights))):
        # real weights on disk: the parity check is one command
        print("\nhint: weights present — validate PSNR parity with "
              f"`python -m satlas_sr_tpu_torch.acceptance --weights {weights} "
              "--data <val_root>` (writes PARITY_RESULTS.json)")
    print(f"\n{errors} error(s), {warns} warning(s)")
    if errors or (strict and warns):
        return 1
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-opt", type=str, required=True,
                        help="Path to the option YAML to diagnose.")
    parser.add_argument("--strict", action="store_true",
                        help="Exit nonzero on warnings too.")
    parser.add_argument("--no_runtime", action="store_true",
                        help="Skip device/codec/kernel-build checks (config only).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the card is checked) or cpu")
    args = parser.parse_args(argv)
    opt = yaml_load(args.opt)
    return run_doctor(opt, strict=args.strict, check_runtime=not args.no_runtime,
                      device=args.device)


if __name__ == "__main__":
    sys.exit(main())

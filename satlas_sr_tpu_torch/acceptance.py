"""One-command parity acceptance against released reference checkpoints.

Counterpart of satlas_sr_tpu/acceptance.py, on the card. The north star's
second half (BASELINE.json) is PSNR parity within 0.05 dB with the released
esrgan checkpoints on the reference val sets; the moment weights and data
are mounted, this is the one command that says whether the port's forward
changes the imagery:

    python -m satlas_sr_tpu_torch.acceptance --workdir acceptance_ws
    python -m satlas_sr_tpu_torch.acceptance --weights path/to/esrgan_8S2.pth \\
        --data path/to/small_val_set --out PARITY_RESULTS.json [--device cpu]

Stages (each recorded in the verdict JSON; the first failure stops the run):
  fetch     resolve the checkpoint and val dataset: a local path, an already
            mounted workdir file, or a registry download (fetch.py; private
            mirrors via --url-weights/--url-data)
  preflight load the .pth (or a JAX-package .msgpack), infer the
            generator family (RRDBNet / SRCNN / HighResNet) and its
            architecture from the tensor shapes
  forward   float forward equality: the port's generator (on the card the RDB
            kernel, float32 by three TF32 products) against the independent
            functional oracle (utils/torch_oracles.py) on identical inputs,
            both in float32 with TF32 off on the same device
  evaluate  dual-path metric run over the val set: every sample is loaded once
            and forwarded through both; PSNR/SSIM/cPSNR (crop_border 4, RGB)
            with the same metric code for both; CLIPScore dual-scored too
            when a pretrained tower is available locally (--clip-model /
            --clip-weights / SSR_TPU_CLIP_WEIGHTS), skipped and recorded
            otherwise (a random tower would gate parity on noise)
  bf16_engine
            the same val images through the production InferenceEngine in
            bfloat16 (the kernel's wgmma route) and a float32 control;
            records the bf16 engine's PSNR against the f32 eval on the same
            bar and selects `at_parity_engine` (bfloat16 or float32_highest);
            informational, never fails acceptance
  verdict   PARITY_RESULTS.json with pass/fail: |PSNR_ours - PSNR_oracle| <=
            --psnr-tol (default 0.05 dB, the same bar on cPSNR), |dCLIPScore|
            <= --clipscore-tol when the CLIP leg runs, forward max|d| <=
            --fwd-tol

The verdict's keys are the JAX module's, so one reader parses both; in
`metrics` and the per-image rows the tag `jax` names the framework under
test, here the port's generator, beside `torch_oracle`. The verdict adds
`device`. Exit codes: 0 pass, 2 parity failure, 3 blocked (artifacts
unavailable). Entry points run on the card (`--device cuda`, the default)
and raise without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .device import resolve_device
from .inference import _precision

# ---------------------------------------------------------------- resolution


def _resolve_weights(spec: str, workdir: str, *, url: Optional[str],
                     no_download: bool) -> str:
    """spec is a local .pth path or a fetch-registry name -> local path."""
    if os.path.isfile(spec):
        return spec
    from .fetch import REGISTRY, fetch_artifact

    if spec not in REGISTRY:
        raise FileNotFoundError(
            f"--weights {spec!r} is neither a file nor a registry name "
            f"(known: {', '.join(sorted(n for n in REGISTRY if n.startswith(('esrgan', 'srcnn', 'highresnet'))))})")
    paths = fetch_artifact(spec, os.path.join(workdir, "weights"), url=url,
                           no_download=no_download, progress=True)
    return paths[0]


def _find_dataset_root(base: str) -> Optional[str]:
    """Locate a dir containing both naip/ and sentinel2/ under base."""
    if not os.path.isdir(base):
        return None
    for root, dirs, _ in os.walk(base):
        if "naip" in dirs and "sentinel2" in dirs:
            return root
        dirs.sort()
    return None


def _resolve_dataset(spec: str, workdir: str, *, url: Optional[str],
                     no_download: bool) -> str:
    """spec is a dataset root (contains naip/ + sentinel2/) or a registry
    name -> extracted dataset root."""
    direct = _find_dataset_root(spec)
    if direct:
        return direct
    from .fetch import REGISTRY, fetch_artifact

    if spec not in REGISTRY:
        raise FileNotFoundError(
            f"--data {spec!r} is neither a dataset tree (naip/ + sentinel2/) "
            f"nor a registry name")
    dest = os.path.join(workdir, "data")
    fetch_artifact(spec, dest, url=url, no_download=no_download, progress=True)
    root = _find_dataset_root(dest)
    if root is None:
        raise FileNotFoundError(
            f"fetched {spec} but no naip/ + sentinel2/ tree found under {dest}")
    return root


# ----------------------------------------------------------------- preflight


def _jax_weights(path: str, param_key: str):
    """A JAX-package .msgpack/.ckpt generator -> (the port's state dict, the
    key taken), its family read off the flax tree (a `body` trunk: RRDBNet;
    `fusion`: HighResNet; else SRCNN)."""
    from .utils.checkpoint import jax_variables_to_port, load_pytree

    blob = load_pytree(path)
    key = next((k for k in (param_key, "params_ema", "params") if k in blob), None)
    if key is None:
        raise ValueError(f"{path} holds no params_ema or params collection")
    params = blob[key]
    arch = "SSR_RRDBNet" if "body" in params else "HighResNet" if "fusion" in params else "SRCNN"
    return jax_variables_to_port(arch, {"params": params}), key


def _load_and_introspect(pth: str, param_key: str, n_frames_hint: int = 8):
    """(state, info): family + hyperparameters inferred from tensor shapes,
    for every released generator family (reference README.md:66-87)."""
    from .utils import torch_io

    if pth.endswith((".msgpack", ".ckpt")):
        state, param_key = _jax_weights(pth, param_key)
    else:
        try:
            state = torch_io.load_torch_state_dict(pth, param_key)
        except KeyError:
            # reference checkpoints carry either params_ema or params
            param_key = "params" if param_key == "params_ema" else "params_ema"
            state = torch_io.load_torch_state_dict(pth, param_key)
    n_params = int(sum(v.numel() for v in state.values()))

    if "conv_first.weight" in state and "body.0.rdb1.conv1.weight" in state:
        info = {
            "family": "rrdbnet",
            "param_key": param_key,
            "num_block": 1 + max(int(k.split(".")[1]) for k in state if k.startswith("body.")),
            "num_in_ch": int(state["conv_first.weight"].shape[1]),
            "num_feat": int(state["conv_first.weight"].shape[0]),
            "num_grow_ch": int(state["body.0.rdb1.conv1.weight"].shape[0]),
            "n_params": n_params,
        }
        return state, info

    if "encoder.doubleconv2d.0.weight" in state:
        enc = state["encoder.doubleconv2d.0.weight"]  # [hidden, in, k, k]
        hidden, in_ch, k = int(enc.shape[0]), int(enc.shape[1]), int(enc.shape[2])
        if "mask_encoder.1.doubleconv2d.0.weight" in state:
            raise ValueError(f"{pth} carries a mask encoder; acceptance evaluates the "
                             f"released mask-free recipes only")
        sr1 = state["sr.upsample.1.weight"]  # [c1, hidden/zoom^2, srk, srk]
        zoom = round((hidden / int(sr1.shape[1])) ** 0.5)
        info = {
            "param_key": param_key,
            "in_channels": in_ch,
            "hidden_channels": hidden,
            "kernel_size": k,
            "out_channels": int(state["sr.upsample.4.weight"].shape[0]),
            "zoom_factor": zoom,
            "output_size": 32 * zoom,
            "sr_kernel_size": int(sr1.shape[2]),
            "n_params": n_params,
        }
        if "fusion.fusion.0.fuse.1.weight" in state:
            info["family"] = "highresnet"
            info["revisits"] = n_frames_hint  # pairwise fusion leaves T free
        else:
            fusion = state["doubleconv2d.doubleconv2d.0.weight"]
            info["family"] = "srcnn"
            info["revisits"] = int(fusion.shape[1]) // hidden
            info["residual_layers"] = 1 + max(
                int(key.split(".")[1]) for key in state if key.startswith("residualblocks."))
        return state, info

    raise ValueError(
        f"{pth} matches no released generator family (keys like "
        f"{sorted(state)[:3]}...); acceptance drives RRDBNet (esrgan_*), "
        f"SRCNN and HighResNet checkpoints")


# ----------------------------------------------------------- forward parity


def _build_family_model(state, info, dtype=torch.float32):
    """(the port's generator on the CPU, in float32, weights loaded; use_3d).
    Shared by the forward pair and the production engines, which differ
    only in compute dtype (the engine casts the weights)."""
    from .archs import SRCNN, HighResNet, RRDBNet
    from .utils.torch_io import drop_shared_fusion_levels

    fam = info["family"]
    if fam == "rrdbnet":
        model = RRDBNet(num_in_ch=info["num_in_ch"], num_out_ch=3, scale=4,
                        num_feat=info["num_feat"], num_block=info["num_block"],
                        num_grow_ch=info["num_grow_ch"], dtype=dtype, device="cpu")
        model.load_state_dict(state)
        return model, False
    arch_kw = dict(in_channels=info["in_channels"], revisits=info["revisits"],
                   hidden_channels=info["hidden_channels"],
                   out_channels=info["out_channels"], kernel_size=info["kernel_size"],
                   output_size=info["output_size"], zoom_factor=info["zoom_factor"],
                   sr_kernel_size=info["sr_kernel_size"], dtype=dtype, device="cpu")
    if fam == "srcnn":
        model = SRCNN(residual_layers=info["residual_layers"], **arch_kw)
        model.load_state_dict(state)
    else:
        model = HighResNet(**arch_kw)
        model.load_state_dict(drop_shared_fusion_levels(state))
    return model, True


def _build_forward_pair(state, info, device: torch.device):
    """(fwd_ours, fwd_oracle, input_shape_tail, model): float NHWC in and out
    ([B, T, H, W, C] in for the 5-D L2 family), float32, TF32 off, on
    `device`; `model` is the port's generator there (its uint8 eval
    forward is the dual eval's)."""
    from .utils import torch_oracles

    sd = {k: v.float().to(device) for k, v in state.items()}
    model, use_3d = _build_family_model(state, info)
    model = model.to(device).eval()

    def fwd_ours(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), _precision("highest"):
            y = model(torch.from_numpy(np.ascontiguousarray(x)).to(device))
        return (y[:, 0] if use_3d else y).float().cpu().numpy()

    fam = info["family"]
    if fam == "rrdbnet":
        def oracle(x):
            return torch_oracles.rrdbnet_forward(sd, x.permute(0, 3, 1, 2), info["num_block"], 4)
        tail = (32, 32, info["num_in_ch"])
    else:
        def oracle(x):
            x = x.permute(0, 1, 4, 2, 3)  # [B, T, C, H, W]
            if fam == "srcnn":
                y = torch_oracles.srcnn_forward(
                    sd, x, info["hidden_channels"], info["residual_layers"], info["output_size"],
                    info["zoom_factor"], info["sr_kernel_size"], k=info["kernel_size"])
            else:
                y = torch_oracles.highresnet_forward(
                    sd, x, info["hidden_channels"], info["output_size"], info["zoom_factor"],
                    info["sr_kernel_size"], k=info["kernel_size"])
            return y[:, 0]
        tail = (info["revisits"], 32, 32, info["in_channels"])

    def fwd_oracle(x: np.ndarray) -> np.ndarray:
        with torch.no_grad(), _precision("highest"):
            y = oracle(torch.from_numpy(np.ascontiguousarray(x)).to(device))
        return y.permute(0, 2, 3, 1).cpu().numpy()

    return fwd_ours, fwd_oracle, tail, model


def _forward_parity(state, info, fwd_tol: float, device: torch.device,
                    batch: int = 2) -> Dict[str, Any]:
    fwd_ours, fwd_oracle, tail, _ = _build_forward_pair(state, info, device)
    x = np.random.RandomState(0).rand(batch, *tail).astype(np.float32)
    y_ours, y_t = fwd_ours(x), fwd_oracle(x)
    diff = float(np.abs(y_ours - y_t).max())
    a8 = (np.clip(y_ours, 0, 1) * 255).round()
    b8 = (np.clip(y_t, 0, 1) * 255).round()
    mse = float(np.mean((a8 - b8) ** 2))
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    return {"max_abs_diff": diff, "uint8_agreement_psnr_db": psnr, "ok": diff <= fwd_tol}


# ------------------------------------------------------------- dual eval


def _val_dataset(info, data_root: str, seed: int):
    from .data.loader import build_dataset

    use_3d = info["family"] in ("srcnn", "highresnet")
    if use_3d:
        n_frames = info["revisits"]
    else:
        n_frames, rem = divmod(info["num_in_ch"], 3)
        if rem:
            raise ValueError(
                f"num_in_ch={info['num_in_ch']} is not a tci frame stack; "
                f"multi-band checkpoints need `python -m "
                f"satlas_sr_tpu_torch.band_order_search` first")
    return build_dataset({
        "name": "acceptance", "type": "S2NAIPDataset", "phase": "test",
        "scale": 4, "sentinel2_path": os.path.join(data_root, "sentinel2"),
        "naip_path": os.path.join(data_root, "naip"),
        "n_s2_images": n_frames, "use_shuffle": False, "seed": seed,
        "use_3d": use_3d,
    }), use_3d, n_frames


def _dual_eval(state, info, data_root: str, *, limit: int, batch_size: int,
               psnr_tol: float, clip_model: str, clip_weights: Optional[str],
               clipscore_tol: float, device: torch.device, seed: int = 0) -> Dict[str, Any]:
    from .metrics.clipscore import calculate_clipscore, tower_pretrained
    from .metrics.cpsnr import calculate_cpsnr
    from .metrics.psnr_ssim import calculate_psnr, calculate_ssim
    from .models.base import to_uint8

    ds, use_3d, _ = _val_dataset(info, data_root, seed)
    n = len(ds) if limit <= 0 else min(limit, len(ds))
    _, fwd_oracle, _, model = _build_forward_pair(state, info, device)

    # CLIPScore leg: dual-scored with the port's tower on both generators'
    # outputs, and only with a real (pretrained) tower
    clip_ready = tower_pretrained(clip_model, clip_weights)
    if not clip_ready:
        print(f"  clipscore leg skipped: no pretrained weights for "
              f"{clip_model} (set SSR_TPU_CLIP_WEIGHTS or --clip-weights)", file=sys.stderr)

    def fwd_ours(lr_u8: np.ndarray) -> np.ndarray:
        # the test CLI's eval forward: /255, generator, to_uint8 (rint)
        with torch.inference_mode(), _precision("highest"):
            y = model(torch.from_numpy(lr_u8).to(device).float() / 255.0)
            return to_uint8(y[:, 0] if use_3d else y).cpu().numpy()

    zero = {"psnr": 0.0, "ssim": 0.0, "cpsnr": 0.0}
    if clip_ready:
        zero["clipscore"] = 0.0
    sums = {"jax": dict(zero), "torch_oracle": dict(zero)}
    per_image: List[Dict[str, float]] = []
    done = 0
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        samples = [ds[i] for i in idxs]
        lr = np.stack([s["lr"] for s in samples])  # uint8, 4-D or 5-D stack
        hr = [s["hr"] for s in samples]            # [128, 128, 3] uint8
        sr_j = fwd_ours(lr)
        y = fwd_oracle(lr.astype(np.float32) / 255.0)
        sr_t = np.rint(np.clip(y, 0, 1) * 255.0).astype(np.uint8)
        for b, i in enumerate(idxs):
            row = {"index": int(i)}
            for tag, sr in (("jax", sr_j[b]), ("torch_oracle", sr_t[b])):
                p = float(calculate_psnr(sr, hr[b], crop_border=4))
                s = float(calculate_ssim(sr, hr[b], crop_border=4))
                c = float(calculate_cpsnr(sr, hr[b], crop_border=4))
                sums[tag]["psnr"] += p
                sums[tag]["ssim"] += s
                sums[tag]["cpsnr"] += c
                row[f"{tag}_psnr"] = p
                row[f"{tag}_cpsnr"] = c
                if clip_ready:
                    cs = float(calculate_clipscore(sr, hr[b], clip_model=clip_model,
                                                   clip_weights_path=clip_weights, device=device))
                    sums[tag]["clipscore"] += cs
                    row[f"{tag}_clipscore"] = cs
            per_image.append(row)
            done += 1
        print(f"\r  evaluated {done}/{n}", end="", file=sys.stderr)
    print(file=sys.stderr)
    if done == 0:
        raise ValueError(f"no usable samples in {data_root}")
    means = {tag: {m: v / done for m, v in d.items()} for tag, d in sums.items()}
    delta = abs(means["jax"]["psnr"] - means["torch_oracle"]["psnr"])
    delta_c = abs(means["jax"]["cpsnr"] - means["torch_oracle"]["cpsnr"])
    worst = max(per_image, key=lambda r: abs(r["jax_psnr"] - r["torch_oracle_psnr"]))
    ok = delta <= psnr_tol and delta_c <= psnr_tol
    out = {
        "images_evaluated": done,
        "metrics": means,
        "delta_psnr_db": delta,
        "delta_cpsnr_db": delta_c,
        "worst_image": {"index": worst["index"],
                        "delta_psnr_db": abs(worst["jax_psnr"] - worst["torch_oracle_psnr"])},
    }
    if clip_ready:
        delta_cs = abs(means["jax"]["clipscore"] - means["torch_oracle"]["clipscore"])
        out["delta_clipscore"] = delta_cs
        out["clip_model"] = clip_model
        ok = ok and delta_cs <= clipscore_tol
    else:
        out["clipscore"] = {"skipped": f"no pretrained weights for {clip_model}"}
    out["ok"] = ok
    return out


# ----------------------------------------------------- production-engine leg


def _production_engine_eval(state, info, data_root: str, *, limit: int, batch_size: int,
                            psnr_tol: float, f32_eval_means: Dict[str, float],
                            device: torch.device, seed: int = 0) -> Dict[str, Any]:
    """The val images through the production InferenceEngine in bfloat16
    (TF32 allowed: matmul_precision default) and a float32 control (TF32
    off), each PSNR/cPSNR against the float32 eval above on the same bar.
    The f32 engine separates the engine's uint8 truncation (the reference
    infer CLI's) from dtype drift. Informational: bf16 beyond the bar
    selects `at_parity_engine: float32_highest`."""
    from .inference import InferenceEngine
    from .metrics.cpsnr import calculate_cpsnr
    from .metrics.psnr_ssim import calculate_psnr

    ds, use_3d, n_frames = _val_dataset(info, data_root, seed)
    n = len(ds) if limit <= 0 else min(limit, len(ds))
    engines = {}
    for tag, dtype, precision in (("f32_engine", torch.float32, "highest"),
                                  ("bf16_engine", torch.bfloat16, "default")):
        model, _ = _build_family_model(state, info, dtype=dtype)
        engines[tag] = InferenceEngine(model, None, batch_size=batch_size, use_3d=use_3d,
                                       n_frames=n_frames if use_3d else None,
                                       matmul_precision=precision, device=device)

    sums = {tag: {"psnr": 0.0, "cpsnr": 0.0} for tag in engines}
    done = 0
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        samples = [ds[i] for i in idxs]
        lr = np.stack([s["lr"] for s in samples])  # 4-D, or the 5-D use_3d stack
        hr = [s["hr"] for s in samples]
        outs = {tag: eng.run(lr) for tag, eng in engines.items()}
        for b in range(len(idxs)):
            for tag in engines:
                sr = outs[tag][b]
                sums[tag]["psnr"] += float(calculate_psnr(sr, hr[b], crop_border=4))
                sums[tag]["cpsnr"] += float(calculate_cpsnr(sr, hr[b], crop_border=4))
            done += 1
        print(f"\r  engine-evaluated {done}/{n}", end="", file=sys.stderr)
    print(file=sys.stderr)
    if done == 0:
        raise ValueError(f"no usable samples in {data_root}")
    means = {tag: {m: v / done for m, v in d.items()} for tag, d in sums.items()}
    d_bf16 = {m: abs(means["bf16_engine"][m] - f32_eval_means[m]) for m in ("psnr", "cpsnr")}
    d_f32 = {m: abs(means["f32_engine"][m] - f32_eval_means[m]) for m in ("psnr", "cpsnr")}
    within = all(v <= psnr_tol for v in d_bf16.values())
    return {
        "images_evaluated": done,
        "metrics": means,
        "delta_bf16_vs_eval_db": d_bf16,
        "delta_f32_engine_vs_eval_db": d_f32,  # truncation-only control
        "delta_bf16_vs_f32_engine_db": {
            m: abs(means["bf16_engine"][m] - means["f32_engine"][m])
            for m in ("psnr", "cpsnr")},       # dtype-only drift
        "bf16_within_bar": within,
        "at_parity_engine": "bfloat16" if within else "float32_highest",
        "ok": True,
    }


# ----------------------------------------------------------------- pipeline


def run_acceptance(args) -> Dict[str, Any]:
    device = resolve_device(args.device)
    verdict: Dict[str, Any] = {
        "command": "satlas_sr_tpu_torch.acceptance",
        "weights": args.weights, "data": args.data, "device": str(device),
        "tolerances": {"psnr_db": args.psnr_tol, "forward_max_abs": args.fwd_tol},
        "timestamp": int(time.time()),
        "stages": {},
        "pass": False,
    }

    def stage(name, fn, blocked_exc=()):
        t0 = time.time()
        try:
            out = fn()
        except blocked_exc as e:
            verdict["stages"][name] = {"ok": False, "blocked": True, "error": str(e)}
            verdict["blocked"] = True
            raise SystemExit(3)
        except Exception as e:  # noqa: BLE001 - the verdict must always be written
            verdict["stages"][name] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            raise SystemExit(2)
        rec = out if isinstance(out, dict) else {"ok": True}
        rec.setdefault("ok", True)
        rec["seconds"] = round(time.time() - t0, 2)
        verdict["stages"][name] = rec
        if not rec["ok"]:
            raise SystemExit(2)
        return out

    try:
        os.makedirs(args.workdir, exist_ok=True)

        def _fetch():
            pth = _resolve_weights(args.weights, args.workdir, url=args.url_weights,
                                   no_download=args.no_download)
            root = _resolve_dataset(args.data, args.workdir, url=args.url_data,
                                    no_download=args.no_download)
            return {"weights_path": pth, "dataset_root": root}

        got = stage("fetch", _fetch, blocked_exc=(OSError, FileNotFoundError))
        loaded = {}

        def _preflight():
            loaded["state"], loaded["info"] = _load_and_introspect(
                got["weights_path"], args.param_key, n_frames_hint=args.n_frames_hint)
            return {"arch": loaded["info"], "weights_path": got["weights_path"]}

        stage("preflight", _preflight)
        state, info = loaded["state"], loaded["info"]

        stage("forward", lambda: _forward_parity(state, info, args.fwd_tol, device))
        ev = stage("evaluate", lambda: _dual_eval(
            state, info, got["dataset_root"], limit=args.limit,
            batch_size=args.batch_size, psnr_tol=args.psnr_tol,
            clip_model=args.clip_model, clip_weights=args.clip_weights,
            clipscore_tol=args.clipscore_tol, device=device))
        if not args.skip_bf16:
            # informational by contract, including on error: an engine that
            # cannot build must not fail an acceptance whose real gates passed
            try:
                prod = stage("bf16_engine", lambda: _production_engine_eval(
                    state, info, got["dataset_root"], limit=args.limit,
                    batch_size=args.batch_size, psnr_tol=args.psnr_tol,
                    f32_eval_means=ev["metrics"]["jax"], device=device))
            except SystemExit:
                if verdict.get("blocked"):
                    raise
                prod = None
                verdict["stages"]["bf16_engine"]["informational"] = True
            verdict["at_parity_engine"] = (prod["at_parity_engine"] if prod
                                           else "float32_highest")
        verdict["pass"] = True
        return verdict
    finally:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2)
        print(f"verdict written to {args.out}", file=sys.stderr)
        status = ("PASS" if verdict["pass"] else
                  "BLOCKED" if verdict.get("blocked") else "FAIL")
        print(f"ACCEPTANCE: {status}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="one-command PSNR-parity acceptance vs a released reference checkpoint")
    ap.add_argument("--weights", default="esrgan_8S2",
                    help="registry name or local .pth path (default: esrgan_8S2)")
    ap.add_argument("--data", default="small_val_set",
                    help="registry name or local dataset root containing naip/ + sentinel2/")
    ap.add_argument("--workdir", default="acceptance_ws", help="where fetched artifacts land")
    ap.add_argument("--param-key", default="params_ema")
    ap.add_argument("--n-frames-hint", type=int, default=8,
                    help="revisits for checkpoints whose weights leave T free (HighResNet "
                         "pairwise fusion); the released recipes use 8")
    ap.add_argument("--psnr-tol", type=float, default=0.05,
                    help="max |PSNR_ours - PSNR_reference| in dB (also the cPSNR delta's)")
    ap.add_argument("--clip-model", default="siglip-ViT-SO400M-14",
                    help="CLIPScore tower; dual-scored only with local pretrained weights")
    ap.add_argument("--clip-weights", default=None,
                    help="local CLIP weights path (falls back to SSR_TPU_CLIP_WEIGHTS)")
    ap.add_argument("--clipscore-tol", type=float, default=0.002,
                    help="max |CLIPScore_ours - CLIPScore_reference| when the CLIP leg runs")
    ap.add_argument("--fwd-tol", type=float, default=1e-4,
                    help="max float forward |diff| vs the torch oracle")
    ap.add_argument("--skip-bf16", action="store_true",
                    help="skip the bfloat16 production-engine leg")
    ap.add_argument("--limit", type=int, default=0, help="cap evaluated images (0 = all)")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--url-weights", default=None, help="mirror URL for the weights artifact")
    ap.add_argument("--url-data", default=None, help="mirror URL for the dataset artifact")
    ap.add_argument("--no-download", action="store_true",
                    help="artifacts are pre-mirrored into the workdir")
    ap.add_argument("--out", default="PARITY_RESULTS.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise, write no verdict
    try:
        verdict = run_acceptance(args)
    except SystemExit as e:
        return int(e.code or 0)
    return 0 if verdict["pass"] else 2


if __name__ == "__main__":
    sys.exit(main())

"""Train-step throughput autotuner CLI (the JAX package's `tune.py`).

    python -m satlas_sr_tpu_torch.tune -opt options/esrgan_s2naip_urban.yml
        --effective_batch 32 [--batches 8,16,32] [--remat auto|false,rdb]
        [--dtypes float32,bfloat16] [--iters 10] [--trials 3]
        [--out tune_results.json] [--device cuda]

Given a train config it measures candidate (batch_size_per_gpu,
network_g.remat, train.accum_steps[, compute_dtype]) settings on the card
with synthetic data of the configured shapes, and reports a ranked table,
the recommended `--force_yml` overrides and a JSON artifact with the JAX
tuner's keys. With --effective_batch E every candidate holds the
optimizer's batch at E (accum_steps = E // batch, non-divisors skipped), so
the ranking compares splits of the same training run; without it the sweep
ranks raw batch sizes (different recipes), and says so.

- Weights are seeded (pretrain and resume paths are dropped): the rate does
  not depend on their values.
- Each candidate builds the model and runs its real `train_iter` (the
  train CLI's step: EMA, schedules, the loss towers of the config), on the
  card through the RDB kernel; the first step (kernel build, cuDNN's
  algorithm search, allocator warm-up) is reported as `compile_s`, then
  `trials` x `iters` steps are timed, `torch.cuda.synchronize` closing
  each trial where the JAX tuner blocks on its logs. ms/step and samples/s
  come from the best trial; `peak_memory_gb` is the card's peak allocation
  over the candidate (null on the CPU).
- Only `torch.OutOfMemoryError` is recorded as a failed candidate (the
  sweep goes on). Every other error propagates: a kernel that fails to
  build or launch stops the sweep instead of becoming a row. (The JAX
  tuner records every exception.)
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .device import resolve_device

LR_CROP = 32  # the dataset's fixed LR chip size (data/s2naip.py)


def _parse_remat_mode(s: str):
    s = s.strip().lower()
    if s in ("false", "none", "off"):
        return False
    if s in ("true", "block"):
        return "block" if s == "block" else True
    if s in ("rdb", "conv_outs"):
        return s
    raise ValueError(f"unknown remat mode {s!r} (expected false|block|rdb|conv_outs)")


def build_candidates(opt: Dict[str, Any], batches: List[int], remat_modes: Optional[List[Any]],
                     effective_batch: Optional[int],
                     dtypes: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Cartesian (batch, remat, dtype) grid; accum from --effective_batch.

    remat_modes=None means 'auto': the config's own setting everywhere, plus
    'rdb' for batches above the smallest candidate. Non-RRDB generators have
    no remat axis and get only the config's setting. dtypes=None keeps the
    config's compute_dtype (no dtype axis); a dtype sweep ranks runs that
    are not numerically identical.
    """
    net_g = opt.get("network_g") or {}
    has_remat_axis = str(net_g.get("type", "")) == "SSR_RRDBNet"
    config_remat = net_g.get("remat", False)
    dtype_axis = dtypes or [None]
    cands = []
    for b in sorted(set(batches)):
        if effective_batch is not None:
            if effective_batch % b:
                continue
            accum = effective_batch // b
        else:
            accum = int((opt.get("train") or {}).get("accum_steps") or 1)
        if not has_remat_axis:
            modes = [config_remat]
        elif remat_modes is None:
            modes = [config_remat]
            if b > min(batches) and "rdb" not in modes:
                modes.append("rdb")
        else:
            modes = remat_modes
        for mode in modes:
            for dt in dtype_axis:
                cand = {"batch": b, "remat": mode, "accum": accum}
                if dt is not None:
                    cand["dtype"] = dt
                cands.append(cand)
    return cands


def synth_batch(opt: Dict[str, Any], rows: int, rng: np.random.RandomState) -> Dict[str, Any]:
    """Synthetic uint8 batch with the config's training shapes."""
    train_ds = (opt.get("datasets") or {}).get("train") or {}
    n_frames = int(train_ds.get("n_s2_images") or 1)
    scale = int(opt.get("scale") or 4)
    hr_size = LR_CROP * scale
    batch = {
        "lr": (rng.rand(rows, LR_CROP, LR_CROP, 3 * n_frames) * 255).astype(np.uint8),
        "hr": (rng.rand(rows, hr_size, hr_size, 3) * 255).astype(np.uint8),
    }
    if train_ds.get("old_naip_path"):
        batch["old_hr"] = (rng.rand(rows, hr_size, hr_size, 3) * 255).astype(np.uint8)
    if str(opt.get("model_type")) == "OSMObjESRGANModel":
        batch["Chip"] = [f"tune_{i}" for i in range(rows)]
    return batch


def candidate_opt(opt: Dict[str, Any], cand: Dict[str, Any]) -> Dict[str, Any]:
    """`opt` with the candidate's overrides, its artifact paths dropped."""
    o = copy.deepcopy(opt)
    if str((o.get("network_g") or {}).get("type", "")) == "SSR_RRDBNet":
        o.setdefault("network_g", {})["remat"] = cand["remat"]
    o.setdefault("train", {})["accum_steps"] = cand["accum"]
    o.setdefault("datasets", {}).setdefault("train", {})["batch_size_per_gpu"] = cand["batch"]
    if cand.get("dtype"):
        o["compute_dtype"] = cand["dtype"]
    path = o.setdefault("path", {})
    for key in list(path):
        if "pretrain_network" in key or "resume_state" in key:
            path[key] = None
    o["is_train"] = True
    o.setdefault("logger", {})["print_freq"] = 1 << 30
    o["logger"]["save_checkpoint_freq"] = 1 << 30
    o["val"] = None
    return o


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_candidate(opt: Dict[str, Any], cand: Dict[str, Any], iters: int, trials: int,
                      device="cuda") -> Dict[str, Any]:
    """Build the model per `cand`'s overrides and time steady-state steps.
    A torch.OutOfMemoryError is recorded (ok False); any other error raises."""
    from .models import build_model

    device = resolve_device(device)
    row = dict(cand)
    o = candidate_opt(opt, cand)
    rows = cand["batch"] * cand["accum"]
    batch = synth_batch(o, rows, np.random.RandomState(0))
    model = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        model = build_model(o, device=device)
        t0 = time.perf_counter()
        model.train_iter(batch, 1)
        _sync(device)
        row["compile_s"] = round(time.perf_counter() - t0, 1)
        best, step = 0.0, 2
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(iters):
                model.train_iter(batch, step)
                step += 1
            _sync(device)
            best = max(best, iters / (time.perf_counter() - t0))
        row["ms_per_step"] = round(1000.0 / best, 1)
        row["samples_per_s"] = round(best * rows, 1)
        row["peak_memory_gb"] = (round(torch.cuda.max_memory_allocated(device) / 1e9, 2)
                                 if device.type == "cuda" else None)
        row["ok"] = True
    except torch.OutOfMemoryError as e:  # infeasible candidate: record, keep sweeping
        row["ok"] = False
        row["error"] = f"{type(e).__name__}: {e}"[:300]
    finally:
        del model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return row


def recommend_force_yml(cand: Dict[str, Any]) -> List[str]:
    remat = cand["remat"]
    remat_s = remat if isinstance(remat, str) else str(bool(remat))
    out = [f"datasets:train:batch_size_per_gpu={cand['batch']}",
           f"network_g:remat={remat_s}",
           f"train:accum_steps={cand['accum']}"]
    if cand.get("dtype"):
        out.append(f"compute_dtype={cand['dtype']}")
    return out


def format_table(results: List[Dict[str, Any]], best: Optional[Dict[str, Any]]) -> str:
    """The ranked markdown table of the candidates that ran."""
    ok = [r for r in results if r["ok"]]
    dtype_col = any("dtype" in r for r in ok)
    hdr = ("| batch | remat | accum |" + (" dtype |" if dtype_col else "")
           + " samples/s | ms/step | compile s | peak GB |")
    lines = [hdr, "|" + "---|" * (hdr.count("|") - 1)]
    for r in sorted(ok, key=lambda r: -r["samples_per_s"]):
        mark = " **" if r is best else ""
        dt = f" {r.get('dtype', '-')} |" if dtype_col else ""
        lines.append(f"| {r['batch']} | {r['remat']} | {r['accum']} |{dt} {r['samples_per_s']}"
                     f"{mark} | {r['ms_per_step']} | {r['compile_s']} | {r['peak_memory_gb']} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Measure train-step throughput across (batch, remat, accum) candidates "
                    "for a config, on the card.")
    ap.add_argument("-opt", dest="opt", required=True)
    ap.add_argument("--batches", default="16,32,64",
                    help="comma-separated per-card native batch sizes")
    ap.add_argument("--remat", default="auto",
                    help="'auto' (config + rdb at larger batches) or a comma list of "
                         "false|block|rdb|conv_outs")
    ap.add_argument("--effective_batch", type=int, default=None,
                    help="hold the optimizer's batch at E (accum_steps = E // batch; "
                         "non-divisors skipped): every candidate is then the same training "
                         "run, split differently")
    ap.add_argument("--dtypes", default=None,
                    help="comma list of compute dtypes to sweep (e.g. float32,bfloat16); "
                         "default: the config's own. Dtypes are not numerically identical.")
    ap.add_argument("--iters", type=int, default=10, help="timed steps per trial")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default="tune_results.json")
    ap.add_argument("--force_yml", nargs="+", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .utils.options import parse_options

    device = resolve_device(args.device)
    parse_argv = ["-opt", args.opt]
    if args.force_yml:
        parse_argv += ["--force_yml"] + list(args.force_yml)
    opt, _ = parse_options(os.getcwd(), is_train=True, argv=parse_argv)

    batches = [int(b) for b in args.batches.split(",") if b.strip()]
    remat_modes = (None if args.remat.strip().lower() == "auto" else
                   [_parse_remat_mode(m) for m in args.remat.split(",")])
    dtypes = [d.strip() for d in args.dtypes.split(",") if d.strip()] if args.dtypes else None
    cands = build_candidates(opt, batches, remat_modes, args.effective_batch, dtypes)
    if not cands:
        print("no feasible candidates (check --batches vs --effective_batch)", file=sys.stderr)
        return 2
    if args.effective_batch is None and len(set(c["batch"] for c in cands)) > 1:
        print("NOTE: no --effective_batch given — this sweep ranks DIFFERENT optimizer-visible "
              "batches (different recipes), not faster splits of the same one. Pass "
              "--effective_batch <global batch> to rank numerically-equivalent candidates.",
              flush=True)

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"tuning {opt['name']} ({opt['model_type']}) on {kind} — {len(cands)} candidates, "
          f"{args.trials}x{args.iters} steps each", flush=True)
    results = []
    for cand in cands:
        label = f"batch={cand['batch']} remat={cand['remat']} accum={cand['accum']}"
        if cand.get("dtype"):
            label += f" dtype={cand['dtype']}"
        print(f"  {label} ...", end="", flush=True)
        row = measure_candidate(opt, cand, args.iters, args.trials, device=device)
        results.append(row)
        if row["ok"]:
            print(f" {row['samples_per_s']} samples/s ({row['ms_per_step']} ms/step, "
                  f"first step {row['compile_s']}s, peak {row['peak_memory_gb']} GB)", flush=True)
        else:
            print(f" FAILED: {row['error']}", flush=True)

    ok = [r for r in results if r["ok"]]
    best = max(ok, key=lambda r: r["samples_per_s"]) if ok else None
    print("\n" + format_table(results, best))
    report = {
        "config": opt["name"],
        "model_type": opt["model_type"],
        "device_kind": kind,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "effective_batch": args.effective_batch,
        "iters": args.iters,
        "trials": args.trials,
        "candidates": results,
        "best": best,
        "recommended_force_yml": recommend_force_yml(best) if best else None,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"\nreport: {args.out}")
    if best:
        print(f"apply with: python -m satlas_sr_tpu_torch.train -opt {args.opt} --force_yml "
              + " ".join(report["recommended_force_yml"]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

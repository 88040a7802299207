"""bfloat16-against-float32 training equivalence on the train-evidence
harness (the JAX package's scripts/dtype_train_equiv.py, on the port's
train CLI).

    python -m satlas_sr_tpu_torch.dtype_train_equiv [--family esrgan|l2] [--iters 300]
        [--workdir DIR] [--bar 0.05] [--fresh] [--out FILE.json] [--device cuda]

Whether a train config can run in `compute_dtype: bfloat16` is a question
about trajectories: does optimizing in bf16 reach the same place? This runs
the real train CLI twice on the identical synthetic-learnable corpus (the
same seed, iterations and recipe as train_evidence, no preemption) with
only compute_dtype flipped, then compares:

  - the train-loss trajectories (first/last window means) and their drop %
    (l_g_pix for esrgan, tot_loss for the l2 WorldStrat trainer);
  - the val-PSNR trajectories and the final val-PSNR delta against --bar
    (0.05 dB by default);
  - the steady-state seconds an iteration, from the train log's timestamps
    between consecutive loss lines (median over segments, the first
    dropped), not from the per-iteration `time:` column -> the speedup.

The train CLI runs with cuDNN's deterministic flag (`DETERMINISTIC_TRAIN`:
the CLI's main after torch.backends.cudnn.deterministic = True), so two
calls of this module on one card train the same trajectories: with
cuDNN's default algorithms the float32 L2 runs differed from call to call
(final val PSNR 6.283-6.290 dB over three calls at 300 iterations on an
NVIDIA H100), a spread that would blur a delta read against a 0.05 dB bar.

A run that errors, or whose loss goes non-finite anywhere, disqualifies the
verdict on its own (`equivalence_verdict`). Verdict JSON: {"family",
"within_bar", "bar_db", "iters", "final_val_psnr_delta_db",
"bf16_speedup_vs_f32", "runs": {dtype: section}, "timestamp"}. Exit 0 iff
both runs completed with finite losses and the delta is within the bar.
The runs go to `--device` (the card by default; this raises without one).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import shutil
import sys
import time

import numpy as np

from . import train_evidence as tev
from .device import resolve_device

#: the per-family train-loss key of the trend comparison
LOSS_KEYS = {"esrgan": "l_g_pix", "l2": "tot_loss"}
#: `python -m satlas_sr_tpu_torch.train`, with cuDNN's deterministic algorithms
DETERMINISTIC_TRAIN = [sys.executable, "-c",
                       "import torch; torch.backends.cudnn.deterministic = True; "
                       "torch.backends.cudnn.benchmark = False; "
                       "from satlas_sr_tpu_torch.train import main; main()"]
_LOSS_LINE = re.compile(r"(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}) INFO: \[.*iter:\s*([\d,]+),")


def steady_iter_seconds(exp_dir):
    """The median seconds an iteration between consecutive loss lines of
    the experiment's train_*.log files (by their timestamps, the first
    segment dropped: it holds the start-up), or None with < 2 segments."""
    stamps = []
    for name in os.listdir(exp_dir):
        if not (name.startswith("train_") and name.endswith(".log")):
            continue
        with open(os.path.join(exp_dir, name)) as f:
            for line in f:
                m = _LOSS_LINE.match(line)
                if m:
                    t = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S")
                    stamps.append((int(m.group(2).replace(",", "")), t))
    stamps.sort()
    seg = [(stamps[i + 1][1] - stamps[i][1]).total_seconds() / (stamps[i + 1][0] - stamps[i][0])
           for i in range(len(stamps) - 1) if stamps[i + 1][0] > stamps[i][0]]
    return float(np.median(seg[1:])) if len(seg) > 1 else None


def _run_one(dtype, args):
    """One train-CLI run at `dtype`: its trajectory section."""
    name = f"dtype_equiv_{args.family}_{dtype}"
    print_freq = max(1, min(50, args.iters // 8))
    val_freq = max(10, min(args.iters // 4, 100))
    opt = tev.FAMILIES[args.family](args.workdir, args.iters, val_freq=val_freq,
                                    ckpt_freq=10 ** 9, print_freq=print_freq)
    opt["name"] = name
    # matmul_precision stays `default` in both runs (the shipped setting):
    # the experiment isolates the compute dtype
    opt["compute_dtype"] = dtype
    yml = tev.write_yml(opt, os.path.join(args.workdir, f"{name}.yml"))

    exp_dir = os.path.join(tev.EXPERIMENTS, name)
    if os.path.isdir(exp_dir):
        shutil.rmtree(exp_dir)

    t0 = time.time()
    rc = tev._launch(yml, args.device, command=DETERMINISTIC_TRAIN).wait()
    wall = time.time() - t0
    if rc != 0:
        return {"error": f"train CLI rc={rc}", "wall_seconds": round(wall, 1)}

    # the trajectories as train_evidence's gate reads them (val rows
    # deduplicated by iter), so the two gates cannot drift
    train_rows, val_rows = tev.load_metrics_rows(os.path.join(exp_dir, "metrics.jsonl"))
    loss_key = LOSS_KEYS[args.family]
    pix = [(r["iter"], r[loss_key]) for r in train_rows if loss_key in r]
    psnrs = [(r["iter"], r["psnr"]) for r in val_rows if r.get("psnr") is not None]
    steady = steady_iter_seconds(exp_dir)

    head = [v for _, v in pix[:4]]
    tail = [v for _, v in pix[-4:]]
    # a diverged run must fail the verdict, not pass on a flat val curve: a
    # non-finite loss anywhere disqualifies on its own
    finite = bool(pix) and bool(np.all(np.isfinite([v for _, v in pix])))
    return {
        "wall_seconds": round(wall, 1),
        "steady_iter_seconds": round(steady, 4) if steady else None,
        "loss_finite": finite,
        "loss_key": loss_key,
        "loss_first": round(float(np.mean(head)), 5) if head else None,
        "loss_last": round(float(np.mean(tail)), 5) if tail else None,
        "loss_drop_pct": (round(100 * (1 - float(np.mean(tail)) / float(np.mean(head))), 1)
                          if head and tail else None),
        "val_psnr": [{"iter": it, "psnr": round(p, 3)} for it, p in psnrs],
    }


def equivalence_verdict(sections, bar):
    """(ok, final_val_psnr_delta, speedup) from the two per-dtype sections.

    Disqualifying on their own, whatever the delta: an "error" section (the
    run crashed or left no logs), and loss_finite false (NaN or inf anywhere
    in the loss trajectory: a diverged run's NaN rows never reach val_psnr,
    so its flat val rows could otherwise match the other run's).
    """
    ok = all("error" not in s and s.get("loss_finite") for s in sections.values())
    delta = speedup = None
    if ok:
        f32, bf16 = sections["float32"], sections["bfloat16"]
        if f32["val_psnr"] and bf16["val_psnr"]:
            delta = abs(bf16["val_psnr"][-1]["psnr"] - f32["val_psnr"][-1]["psnr"])
        if f32["steady_iter_seconds"] and bf16["steady_iter_seconds"]:
            speedup = f32["steady_iter_seconds"] / bf16["steady_iter_seconds"]
        ok = delta is not None and delta <= bar
    return ok, delta, speedup


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(tev.FAMILIES), default="esrgan",
                    help="trainer family to compare (l2: the SRCNN/HighResNet WorldStrat "
                         "trainer)")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--workdir", default=os.path.join(tev.EXPERIMENTS, "sr_dtype_equiv"))
    ap.add_argument("--bar", type=float, default=0.05,
                    help="max |final val PSNR(bf16) - final val PSNR(f32)| dB")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the train CLI's device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card, no run

    tev.make_corpus(args.workdir, args.fresh)
    sections = {}
    for dtype in ("float32", "bfloat16"):
        print(f"\n>>> training {args.iters} iters with compute_dtype={dtype}", flush=True)
        sections[dtype] = _run_one(dtype, args)
        print(json.dumps(sections[dtype], indent=2))

    ok, delta, speedup = equivalence_verdict(sections, args.bar)
    verdict = {
        "family": args.family,
        "within_bar": bool(ok),
        "bar_db": args.bar,
        "iters": args.iters,
        "final_val_psnr_delta_db": round(delta, 4) if delta is not None else None,
        "bf16_speedup_vs_f32": round(speedup, 3) if speedup else None,
        "runs": sections,
        "timestamp": int(time.time()),
    }
    print("\n==== dtype equivalence:", "WITHIN BAR" if ok else "OUT OF BAR",
          f"(Δ final val PSNR = {delta} dB, speedup = {speedup}) ====")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2)
        print(f"artifact written to {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

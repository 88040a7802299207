"""End-to-end training evidence on the card (the JAX package's
scripts/train_evidence.py, on the port's train CLI).

    python -m satlas_sr_tpu_torch.train_evidence [--iters 1200] [--family both|esrgan|l2]
        [--workdir DIR] [--preempt_frac 0.4] [--psnr_margin 0.05] [--fresh]
        [--out FILE.json] [--device cuda]

Drives the real train CLI (`python -m satlas_sr_tpu_torch.train`) over a
synthetic but learnable S2-NAIP tree for both trainer families:

  esrgan - the production-shaped SSRESRGANModel (RRDBNet 64 feat / 23
           blocks, batch 32, bfloat16, the shipped urban config's losses and
           optimizers, VGG19 perceptual, U-Net SN discriminator);
  l2     - L2Model over the shipped HighResNet shapes (hidden 128, revisits
           8, WorldStrat loss, float32, lr 2e-3).

HR chips are smooth random fields and every LR frame is the 4x box
downsample of its HR plus small noise, so there is a true SR mapping to
learn, and held-out val PSNR rises only if the assembled trainer (data
pipeline, USM, GAN step, EMA, scheduler, checkpoint and resume,
validation) optimizes.

Each run is preempted with SIGTERM at `--preempt_frac` of its iterations
(the train CLI saves a full state at the next iteration boundary) and
resumed with --auto_resume, so the evidence covers the recovery path too.
The exit code is nonzero unless, for every family, the train loss fell by
20% and val PSNR rose by >= --psnr_margin dB, pointwise or by least-squares
fit over the val trajectory (`_psnr_gate`), the discriminator losses stayed
bounded (esrgan) and the resumed process reached total_iter. Duplicate val
rows at one iter (the resume leg re-validates at its final iter) are
deduplicated, keeping the last.

The corpus (48 train and 8 val chips from RandomState(0)) goes under
--workdir, the experiments under experiments/ of the repository, as the
train CLI puts them. The children run on `--device` (the card by default;
this command raises without one). --out writes the verdict: {"pass",
"iters", "psnr_margin_db", "families": {name: {pix_drop_pct,
val_psnr_rise_db, val_psnr_fit_rise_db, resumed_ok, ...}}, "timestamp"}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

from .device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: where the runs' experiment directories go (the train CLI's default root)
EXPERIMENTS = os.path.join(REPO, "experiments")
PSNR_MARGIN_DB = 0.05  # default noise margin on the val-PSNR rise
POLL_SECONDS = 5.0  # how often the preemption leg reads metrics.jsonl


def _smooth_field(rng, size=128, base=16, lo=30, hi=225):
    """Low-frequency random RGB field: upsampled coarse noise."""
    from PIL import Image

    coarse = rng.rand(base, base, 3)
    chans = [
        np.asarray(Image.fromarray((c * 255).astype(np.uint8)).resize((size, size), Image.BILINEAR),
                   dtype=np.float32)
        for c in coarse.transpose(2, 0, 1)
    ]
    img = np.stack(chans, axis=-1) / 255.0
    return (lo + img * (hi - lo)).astype(np.uint8)


def _make_split(root, n_chips, rng, n_frames=8):
    from PIL import Image

    from .utils.imgio import write_png

    for k in range(n_chips):
        chip = f"chip{k:04d}"
        hr = _smooth_field(rng)
        # the true 4x relationship: LR frames are the box-downsampled HR + noise
        lr = np.asarray(Image.fromarray(hr).resize((32, 32), Image.BOX), dtype=np.float32)
        frames = []
        for _ in range(n_frames):
            f = lr + rng.randn(32, 32, 3) * 2.0
            frames.append(np.clip(f, 1, 255).astype(np.uint8))  # no zero pixels
        write_png(os.path.join(root, "naip", chip, f"{chip}.png"), hr)
        write_png(os.path.join(root, "sentinel2", chip, "tci.png"), np.concatenate(frames, axis=0))


def _dataset_block(workdir, use_3d):
    d = {
        "train": {
            "name": "train",
            "type": "S2NAIPDataset",
            "sentinel2_path": os.path.join(workdir, "train", "sentinel2"),
            "naip_path": os.path.join(workdir, "train", "naip"),
            "use_shuffle": True,
            "num_worker_per_gpu": 2,
            "batch_size_per_gpu": 32,
            "n_s2_images": 8,
            "io_backend": {"type": "disk"},
        },
        "val": {
            "name": "validation",
            "type": "S2NAIPDataset",
            "sentinel2_path": os.path.join(workdir, "val", "sentinel2"),
            "naip_path": os.path.join(workdir, "val", "naip"),
            "use_shuffle": False,
            "n_s2_images": 8,
            "io_backend": {"type": "disk"},
        },
    }
    if use_3d:
        d["train"]["use_3d"] = True
        d["val"]["use_3d"] = True
    return d


def _val_block(val_freq):
    return {
        "val_freq": val_freq,
        "save_img": False,
        "metrics": {
            "psnr": {"type": "calculate_psnr", "crop_border": 4, "test_y_channel": False},
            "ssim": {"type": "calculate_ssim", "crop_border": 4, "test_y_channel": False},
        },
    }


def _logger_block(print_freq, ckpt_freq):
    return {"print_freq": print_freq, "save_checkpoint_freq": ckpt_freq,
            "use_tb_logger": False, "wandb": {"project": None, "resume_id": None}}


def _esrgan_opt(workdir, iters, val_freq, ckpt_freq, print_freq):
    """The production-shaped GAN recipe (esrgan_s2naip_urban.yml shapes)."""
    return {
        "name": "evidence_esrgan",
        "model_type": "SSRESRGANModel",
        "scale": 4,
        "num_gpu": "auto",
        "manual_seed": 0,
        "l1_gt_usm": True,
        "percep_gt_usm": True,
        "gan_gt_usm": False,
        "feed_disc_lr": True,
        "compute_dtype": "bfloat16",
        "matmul_precision": "default",
        "datasets": _dataset_block(workdir, use_3d=False),
        "network_g": {"type": "SSR_RRDBNet", "num_in_ch": 24, "num_out_ch": 3,
                      "num_feat": 64, "num_block": 23, "num_grow_ch": 32},
        "network_d": {"type": "SSR_UNetDiscriminatorSN", "num_in_ch": 27,
                      "num_feat": 64, "skip_connection": True},
        "path": {"param_key_g": "params_ema", "strict_load_g": True,
                 "param_key_d": "params", "strict_load_d": True, "resume_state": None},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1.0e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1.0e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [400000], "gamma": 0.5},
            "total_iter": iters,
            "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "perceptual_opt": {
                "type": "PerceptualLoss",
                "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                                  "conv4_4": 1, "conv5_4": 1},
                "vgg_type": "vgg19", "use_input_norm": True,
                "perceptual_weight": 1.0, "style_weight": 0,
                "range_norm": False, "criterion": "l1",
            },
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 0.1},
            "net_d_iters": 1,
            "net_d_init_iters": 0,
        },
        "val": _val_block(val_freq),
        "logger": _logger_block(print_freq, ckpt_freq),
    }


def _l2_opt(workdir, iters, val_freq, ckpt_freq, print_freq):
    """The shipped HighResNet shapes and the WorldStrat-loss L2 trainer
    (options/highresnet_s2naip_urban.yml)."""
    return {
        "name": "evidence_l2",
        "model_type": "L2Model",
        "scale": 4,
        "num_gpu": "auto",
        "manual_seed": 0,
        "compute_dtype": "float32",
        "matmul_precision": "default",
        "datasets": _dataset_block(workdir, use_3d=True),
        "network_g": {"type": "HighResNet", "in_channels": 3, "mask_channels": 0,
                      "hidden_channels": 128, "out_channels": 3, "kernel_size": 3,
                      "residual_layers": 1, "output_size": 128, "revisits": 8,
                      "zoom_factor": 4, "sr_kernel_size": 1},
        "path": {"param_key_g": "params_ema", "strict_load_g": True,
                 "param_key_d": "params", "strict_load_d": True, "resume_state": None},
        "train": {
            # 2e-3, not the shipped recipe's 1e-4: this is a learnability gate,
            # and at 1e-4 this family's val PSNR stays flat for 300 iterations
            # (the net's output scale grows toward the target's ~0.5 at ~lr a
            # step). The shipped HighResNet recipe keeps its own lr.
            "optim_g": {"type": "Adam", "lr": 2.0e-3, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [400000], "gamma": 0.5},
            "total_iter": iters,
            "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
        },
        "val": _val_block(val_freq),
        "logger": _logger_block(print_freq, ckpt_freq),
    }


FAMILIES = {"esrgan": _esrgan_opt, "l2": _l2_opt}


def write_yml(opt, path):
    """`opt` as YAML at `path`, its experiment under EXPERIMENTS."""
    import yaml

    opt["path"]["experiments_root"] = EXPERIMENTS
    with open(path, "w") as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return path


def _write_config(family, workdir, iters, val_freq, ckpt_freq):
    # short smoke runs still need train-loss rows for the trend gate
    print_freq = max(1, min(50, iters // 8))
    opt = FAMILIES[family](workdir, iters, val_freq, ckpt_freq, print_freq)
    return write_yml(opt, os.path.join(workdir, f"evidence_{family}.yml")), opt["name"]


def _launch(yml, device="cuda", command=None):
    """The train CLI on `yml` with --auto_resume, as a child process.
    `command` replaces `python -m satlas_sr_tpu_torch.train` (a wrapper that
    takes the same arguments)."""
    cmd = list(command) if command else [sys.executable, "-m", "satlas_sr_tpu_torch.train"]
    return subprocess.Popen(cmd + ["-opt", yml, "--auto_resume", "--device", str(device)],
                            cwd=REPO)


def _last_iter(metrics_path):
    """The highest iter any metrics.jsonl row (train or validation) reports.

    Validation rows must count: train rows appear only every print_freq
    iterations, so a run whose total_iter is not a print_freq multiple logs
    its last train row short of total_iter (296 for print_freq 37 and
    total_iter 300), while the end-of-training validation row carries the
    true final iter.
    """
    last = 0
    try:
        with open(metrics_path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(row.get("iter"), int):
                    last = max(last, row["iter"])
    except FileNotFoundError:
        pass
    return last


def load_metrics_rows(metrics_path):
    """metrics.jsonl -> (train rows sorted by iter, val rows deduplicated by
    iter keeping the last: a resume leg re-runs its final validation).
    Shared with dtype_train_equiv, so the two gates read trajectories alike."""
    train_rows, val_rows = [], []
    with open(metrics_path) as f:
        for line in f:
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            (val_rows if "val_dataset" in row else train_rows).append(row)
    train_rows.sort(key=lambda r: r.get("iter", 0))
    by_iter = {}
    for r in val_rows:
        if isinstance(r.get("iter"), int):
            by_iter[r["iter"]] = r
    return train_rows, [by_iter[it] for it in sorted(by_iter)]


def _psnr_gate(psnrs, margin):
    """(rise, fit_rise, ok) over the val trajectory of (iter, psnr) pairs,
    deduplicated and sorted. ok when the pointwise rise last - first >=
    margin, or the least-squares fit over the whole trajectory rises >=
    margin across its iter span (robust to one noisy endpoint); all None
    with fewer than two points."""
    if len(psnrs) < 2:
        return None, None, None
    its = np.array([it for it, _ in psnrs], dtype=np.float64)
    vals = np.array([p for _, p in psnrs], dtype=np.float64)
    rise = float(vals[-1] - vals[0])
    slope = float(np.polyfit(its, vals, 1)[0])
    fit_rise = slope * float(its[-1] - its[0])
    return rise, fit_rise, (rise >= margin or fit_rise >= margin)


def run_family(family, args, command=None):
    """One family's evidence leg: (artifact section, ok). `args` carries
    iters, workdir, preempt_frac, psnr_margin and device; `command` is
    handed to `_launch`."""
    run_name = f"evidence_{family}"
    # the gate judges this run only: a stale experiment dir would make
    # --auto_resume skip the training and the trend gate read its rows
    exp_dir = os.path.join(EXPERIMENTS, run_name)
    if os.path.isdir(exp_dir):
        print(f"removing stale experiment dir {exp_dir}", flush=True)
        shutil.rmtree(exp_dir)

    # >= 4 val points when possible (the fit gate wants a trajectory, not
    # two endpoints), at most one validation every 100 iterations
    val_freq = max(10, min(args.iters // 4, 100))
    yml, _ = _write_config(family, args.workdir, args.iters, val_freq=val_freq,
                           ckpt_freq=val_freq)
    metrics = os.path.join(exp_dir, "metrics.jsonl")

    t0 = time.time()
    resumed_ok = None
    proc = _launch(yml, args.device, command)
    if args.preempt_frac > 0:
        target = int(args.iters * args.preempt_frac)
        while proc.poll() is None and _last_iter(metrics) < target:
            time.sleep(POLL_SECONDS)
        if proc.poll() is None:
            print(f"\n>>> [{family}] preempting (SIGTERM) at iter ~{_last_iter(metrics)}",
                  flush=True)
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
        print(f">>> [{family}] preempted run exited rc={rc}; resuming", flush=True)
        preempt_iter = _last_iter(metrics)
        proc = _launch(yml, args.device, command)
    rc = proc.wait()
    wall = time.time() - t0
    if args.preempt_frac > 0:
        # the resumed process must have carried the run to total_iter
        resumed_ok = rc == 0 and _last_iter(metrics) >= args.iters and preempt_iter < args.iters
    if rc != 0:
        print(f"[{family}] train CLI failed rc={rc}")
        return {"pass": False, "error": f"train CLI rc={rc}"}, False

    train_rows, val_rows = load_metrics_rows(metrics)
    # the train-loss key differs per family: the GAN logs l_g_pix, L2 tot_loss
    loss_key = "l_g_pix" if family == "esrgan" else "tot_loss"
    head = [r[loss_key] for r in train_rows[:4] if loss_key in r]
    tail = [r[loss_key] for r in train_rows[-4:] if loss_key in r]
    d_real = [r["l_d_real"] for r in train_rows if "l_d_real" in r]
    d_fake = [r["l_d_fake"] for r in train_rows if "l_d_fake" in r]
    print(f"\n==== [{family}] evidence summary ({wall:.0f}s wall) ====")
    print(f"train rows: {len(train_rows)}  val rows: {len(val_rows)}")
    if head and tail:
        print(f"{loss_key}: first≈{np.mean(head):.4f} -> last≈{np.mean(tail):.4f}")
    if d_real and d_fake:
        print(f"l_d_real range [{min(d_real):.3f}, {max(d_real):.3f}]  "
              f"l_d_fake range [{min(d_fake):.3f}, {max(d_fake):.3f}]")
    psnrs = [(r["iter"], r.get("psnr")) for r in val_rows if r.get("psnr") is not None]
    for it, p in psnrs:
        print(f"  val @ {it}: psnr {p:.3f}")
    rise, fit_rise, psnr_ok = _psnr_gate(psnrs, args.psnr_margin)
    ok = True
    if not head or not tail or np.mean(tail) >= np.mean(head) * 0.8:
        print(f"FAIL: {loss_key} did not fall by >=20%")
        ok = False
    if psnr_ok is False:
        print(f"FAIL: val PSNR rose <{args.psnr_margin} dB "
              f"(pointwise {rise:+.3f}, fit {fit_rise:+.3f})")
        ok = False
    elif psnr_ok is None:
        # fewer than 2 val points is a broken validation pipeline, not a pass
        print(f"FAIL: <2 val PSNR points reached metrics.jsonl ({len(psnrs)}): "
              "validation did not run or record")
        ok = False
    if family == "esrgan" and not (d_real and d_fake and max(map(abs, d_real + d_fake)) < 50):
        print("FAIL: discriminator losses unbounded or missing")
        ok = False
    if resumed_ok is False:
        print("FAIL: resumed run did not reach total_iter")
        ok = False
    print(f"[{family}] EVIDENCE:", "PASS" if ok else "FAIL")
    section = {
        "pass": ok,
        "wall_seconds": round(wall, 1),
        "loss_key": loss_key,
        "pix_drop_pct": (round(100 * (1 - float(np.mean(tail)) / float(np.mean(head))), 1)
                         if head and tail else None),
        "loss_first": round(float(np.mean(head)), 5) if head else None,
        "loss_last": round(float(np.mean(tail)), 5) if tail else None,
        "val_psnr": [{"iter": it, "psnr": round(p, 3)} for it, p in psnrs],
        "val_psnr_rise_db": round(rise, 4) if rise is not None else None,
        "val_psnr_fit_rise_db": round(fit_rise, 4) if fit_rise is not None else None,
        "val_psnr_rose": psnr_ok,
        "resumed_ok": resumed_ok,
    }
    if d_real and d_fake:
        section["d_loss_bounds"] = {
            "l_d_real": [round(min(d_real), 4), round(max(d_real), 4)],
            "l_d_fake": [round(min(d_fake), 4), round(max(d_fake), 4)],
        }
    return section, ok


def make_corpus(workdir, fresh=False):
    """The protocol's tree under `workdir` (48 train and 8 val chips from
    RandomState(0)), unless it is there already and `fresh` is off."""
    marker = os.path.join(workdir, ".generated")
    if fresh or not os.path.exists(marker):
        print("generating synthetic learnable S2-NAIP tree ...", flush=True)
        rng = np.random.RandomState(0)
        _make_split(os.path.join(workdir, "train"), 48, rng)
        _make_split(os.path.join(workdir, "val"), 8, rng)
        open(marker, "w").close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1200)
    ap.add_argument("--family", default="both", choices=["both", "esrgan", "l2"])
    ap.add_argument("--workdir", default=os.path.join(EXPERIMENTS, "sr_evidence"))
    ap.add_argument("--preempt_frac", type=float, default=0.4,
                    help="SIGTERM each run at this fraction of total_iter "
                         "(0 disables the preemption leg)")
    ap.add_argument("--psnr_margin", type=float, default=PSNR_MARGIN_DB,
                    help="required val-PSNR rise in dB (pointwise or by fit)")
    ap.add_argument("--fresh", action="store_true", help="regenerate the synthetic dataset")
    ap.add_argument("--out", default=None, help="write the verdict as machine-readable JSON here")
    ap.add_argument("--device", default="cuda",
                    help="the train CLI's device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card, no run

    make_corpus(args.workdir, args.fresh)
    families = ["esrgan", "l2"] if args.family == "both" else [args.family]
    sections, all_ok = {}, True
    for family in families:
        section, ok = run_family(family, args)
        sections[family] = section
        all_ok = all_ok and ok

    print("\n==== OVERALL:", "PASS" if all_ok else "FAIL", "====")
    if args.out:
        artifact = {"pass": all_ok, "iters": args.iters, "psnr_margin_db": args.psnr_margin,
                    "families": sections, "timestamp": int(time.time())}
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
        print(f"artifact written to {args.out}")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())

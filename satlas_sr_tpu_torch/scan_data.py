"""Dataset scan CLI: validate an S2-NAIP tree BEFORE training on it.

    python -m satlas_sr_tpu_torch.scan_data -opt options/esrgan_s2naip_urban.yml
    python -m satlas_sr_tpu_torch.scan_data -opt cfg.yml --dataset val --json report.json

A copy of satlas_sr_tpu/scan_data.py on the port's dataset (data/s2naip.py)
and PNG reader (utils/imgio.py): host code, no device.

Applies EXACTLY the predicates the training pipeline uses to skip a chip
(data/s2naip.py _load — naip black pixels, undecodable/mis-shaped band
pngs, cross-band frame-count mismatch, too few frames) and reports how
much of the tree is actually trainable. The reference discovers bad data
one skip-and-advance at a time, mid-training, silently; a tree where
every chip is bad spins its loader forever. (An unreadable NAIP png is
skipped here with a warning; the REFERENCE reads it outside its skip
guard, s2-naip_dataset.py:171, and crashes when that chip is drawn.)

Also reports frame-goodness stats: frame selection prefers non-black
frames, so a chip whose frames are ALL black still trains but only with
degraded inputs: worth knowing before a 400k-iter run.

Exit status: 0, or 1 with --strict when any chip is unusable.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List

import numpy as np


def scan_dataset(ds, limit: int = 0) -> Dict[str, Any]:
    """Scan an S2NAIPDataset's datapoints; returns the report dict."""
    from .data.s2naip import has_black_pixels
    from .utils.imgio import read_png  # same reader the dataset uses

    issues: Dict[str, List[str]] = {
        "naip_unreadable": [], "naip_black_pixels": [],
        "bands_invalid": [], "too_few_frames": [], "all_frames_black": [],
    }
    frame_counts: List[int] = []
    good_frame_ratio: List[float] = []
    points = ds.datapoints[:limit] if limit else ds.datapoints

    for naip_path, s2_paths, chip, _old in points:
        try:
            naip = read_png(naip_path)
            if naip is None:
                raise ValueError("decode failed")
        except Exception:
            issues["naip_unreadable"].append(chip)
            continue
        if has_black_pixels(naip):
            issues["naip_black_pixels"].append(chip)
            continue
        s2 = ds._load_bands(s2_paths)
        if s2 is None:
            issues["bands_invalid"].append(chip)
            continue
        frame_counts.append(int(s2.shape[0]))
        if s2.shape[0] < ds.n_s2_images:
            issues["too_few_frames"].append(chip)
            continue
        # goodness: a frame is "good" when its TCI channels carry no black
        # pixels — the trainer's good-first frame preference judges tci
        # only (data/s2naip.py: has_black_pixels over s2[..., :3])
        tci = s2[..., :3].sum(axis=-1, dtype=np.int64)  # [T, 32, 32]
        bad_frame = (tci == 0).reshape(s2.shape[0], -1).any(axis=1)
        good = int((~bad_frame).sum())
        good_frame_ratio.append(good / s2.shape[0])
        if good == 0:
            issues["all_frames_black"].append(chip)

    n = len(points)
    unusable = sum(len(v) for k, v in issues.items()
                   if k != "all_frames_black")
    report = {
        "chips_scanned": n,
        "chips_usable": n - unusable,
        "chips_unusable": unusable,
        # chips that CRASH the REFERENCE when drawn (skipped here)
        "chips_fatal_in_reference": len(issues["naip_unreadable"]),
        "issues": {k: {"count": len(v), "examples": v[:20]}
                   for k, v in issues.items()},
        "frames": {
            "min": int(min(frame_counts)) if frame_counts else None,
            "max": int(max(frame_counts)) if frame_counts else None,
            "required": int(ds.n_s2_images),
        },
        "good_frame_ratio_mean": (float(np.mean(good_frame_ratio))
                                  if good_frame_ratio else None),
    }
    return report


def print_report(report: Dict[str, Any]) -> None:
    print(f"chips scanned:  {report['chips_scanned']}")
    print(f"chips usable:   {report['chips_usable']}")
    print(f"chips unusable: {report['chips_unusable']}")
    if report.get("chips_fatal_in_reference"):
        print(f"note: {report['chips_fatal_in_reference']} unreadable NAIP "
              f"png(s) — skipped here with a warning; the reference CRASHES "
              f"on these when drawn")
    for name, info in report["issues"].items():
        if info["count"]:
            ex = ", ".join(info["examples"][:5])
            print(f"  {name}: {info['count']} (e.g. {ex})")
    fr = report["frames"]
    if fr["min"] is not None:
        print(f"frames per chip: {fr['min']}..{fr['max']} "
              f"(config requires {fr['required']})")
    if report["good_frame_ratio_mean"] is not None:
        print(f"mean non-black frame ratio: "
              f"{report['good_frame_ratio_mean']:.3f}")


def main(argv=None) -> int:
    from .data.loader import build_dataset
    from .utils.options import yaml_load

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-opt", type=str, required=True)
    parser.add_argument("--dataset", default="train",
                        help="datasets/test_datasets block to scan")
    parser.add_argument("--limit", type=int, default=0,
                        help="scan only the first N chips")
    parser.add_argument("--json", type=str, default=None,
                        help="also write the report as JSON")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 when any chip is unusable")
    args = parser.parse_args(argv)

    opt = yaml_load(args.opt)
    blocks = dict(opt.get("datasets") or {})
    blocks.update(opt.get("test_datasets") or {})
    if args.dataset not in blocks:
        print(f"no dataset block named {args.dataset!r}; available: "
              f"{sorted(blocks)}", file=sys.stderr)
        return 2
    ds_opt = dict(blocks[args.dataset])
    ds_opt.setdefault("phase", args.dataset.split("_")[0])
    ds_opt.setdefault("scale", opt.get("scale", 4))
    # discovery must see EVERY chip: scan the full tree even when the train
    # config subsamples, and keep OSM filtering as configured
    ds_opt.pop("train_samples", None)
    ds = build_dataset(ds_opt)

    report = scan_dataset(ds, limit=args.limit)
    print_report(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {args.json}")
    if args.strict and report["chips_unusable"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

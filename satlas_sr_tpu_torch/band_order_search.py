"""Recover the trained band order of a multi-band ESRGAN checkpoint (the JAX
package's scripts/band_order_search.py, on the port's generator).

    python -m satlas_sr_tpu_torch.band_order_search weights/esrgan_10m.pth data/val_set
        [--n-frames 8] [--limit 16] [--bands b05 b06 ...] [--param-key params_ema]
        [--max-candidates 1000] [--out report.json] [--device cuda]

The released esrgan_{10m,20m,60m}.pth generators carry no `s2_bands` list.
The order is recoverable empirically, because the right stacking is the one
that super-resolves: score every admissible band arrangement by val PSNR
and the trained order wins by a wide margin (a wrong order feeds band data
into conv_first channels trained for other spectra).

Method:
  1. num_in_ch, num_feat, num_block and num_grow_ch from the state dict's
     shapes; channels a frame = num_in_ch / n_frames.
  2. Candidates = ordered arrangements of the bands present on disk whose
     channel widths (tci 3, every other band 1) sum to the channels a
     frame; tci, when included, pinned first (the dataset forces that, so
     any other position is unreachable).
  3. Every candidate scores on the same deterministic frames (the first
     n_frames of each chip, no goodness sampling): the --limit chips as one
     batch through the port's RRDBNet in float32 with TF32 off (on the card
     the RDB kernel's float32 route), outputs rounded to uint8 by rint,
     PSNR with crop_border 4 against the NAIP GT, averaged over the chips.
  4. A ranked report and the `s2_bands:` YAML line to paste into a config
     (options/zoo/infer_esrgan_{10m,20m,60m}.yml).
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import sys

import numpy as np
import torch

from .device import resolve_device


def enumerate_orders(available, cpf, max_candidates=1000):
    """Ordered band arrangements of total width `cpf`; tci pinned first."""
    singles = sorted(b for b in available if b != "tci")
    out = []

    def add(order):
        out.append(order)
        if len(out) > max_candidates:
            raise ValueError(f"more than {max_candidates} candidate orders; narrow the pool "
                             f"with --bands")

    if "tci" in available and cpf >= 3:
        for combo in itertools.permutations(singles, cpf - 3):
            add(["tci"] + list(combo))
    for combo in itertools.permutations(singles, cpf):
        add(list(combo))
    return out


def load_stack(chip_dir, bands, n_frames):
    """[32, 32, n_frames * width(bands)] uint8 stacked in the given order.

    Simpler than the training loader on purpose: the first n_frames frames,
    no tci goodness sampling, so the ranking is a function of band order
    alone. None when a band is missing or short (the chip is then skipped
    for every candidate alike).
    """
    from .utils.imgio import read_png

    per_band = []
    for band in bands:
        path = os.path.join(chip_dir, f"{band}.png")
        if not os.path.exists(path):
            return None
        img = read_png(path)
        if img.shape[0] % 32 != 0 or img.shape[1] != 32:
            return None
        frames = img.reshape(-1, 32, 32, img.shape[-1])
        if frames.shape[0] < n_frames:
            return None
        per_band.append(frames[:n_frames])
    picked = np.concatenate(per_band, axis=-1)  # [T, 32, 32, cpf]
    return np.concatenate(list(picked), axis=-1)  # [32, 32, T * cpf]


def generator(state, device):
    """The port's RRDBNet for a reference state dict, its widths read from
    the tensors' shapes: (model, num_in_ch)."""
    from .archs import RRDBNet

    num_in_ch = int(state["conv_first.weight"].shape[1])
    num_feat = int(state["conv_first.weight"].shape[0])
    num_block = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("body."))
    num_grow_ch = int(state["body.0.rdb1.conv1.weight"].shape[0])
    model = RRDBNet(num_in_ch=num_in_ch, num_out_ch=3, scale=4, num_feat=num_feat,
                    num_block=num_block, num_grow_ch=num_grow_ch, device=device)
    model.load_state_dict(state)
    return model.eval(), num_in_ch


def super_resolve(model, stacks: np.ndarray, device) -> np.ndarray:
    """uint8 [B, 32, 32, C] -> uint8 [B, 128, 128, 3]: float32 with TF32
    off, clipped to [0, 1], x255, rounded half to even."""
    from .inference import _precision

    with _precision("highest"), torch.no_grad():
        y = model(torch.from_numpy(stacks).to(device).float() / 255.0)
        y = torch.round(y.float().clamp(0.0, 1.0) * 255.0)
    return y.to(torch.uint8).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="rank candidate s2_bands orders for a multi-band .pth by val PSNR")
    ap.add_argument("checkpoint", help="esrgan_{10m,20m,60m}-style .pth")
    ap.add_argument("data_root", help="val root containing naip/ + sentinel2/")
    ap.add_argument("--n-frames", type=int, default=8, help="frames the checkpoint stacks")
    ap.add_argument("--param-key", default="params_ema")
    ap.add_argument("--limit", type=int, default=16, help="chips scored per candidate")
    ap.add_argument("--bands", nargs="*", default=None, help="restrict the candidate band pool")
    ap.add_argument("--max-candidates", type=int, default=1000)
    ap.add_argument("--out", default=None, help="write the ranking as JSON")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from .metrics.psnr_ssim import calculate_psnr
    from .utils.imgio import read_png
    from .utils.torch_io import load_torch_state_dict

    state = load_torch_state_dict(args.checkpoint, args.param_key)
    model, num_in_ch = generator(state, device)
    cpf, rem = divmod(num_in_ch, args.n_frames)
    if rem:
        raise SystemExit(f"num_in_ch={num_in_ch} not divisible by n_frames={args.n_frames}")
    print(f"{os.path.basename(args.checkpoint)}: num_in_ch={num_in_ch} -> "
          f"{cpf} channels/frame at {args.n_frames} frames")

    s2_root = os.path.join(args.data_root, "sentinel2")
    chip_dirs = sorted(d for d in glob.glob(os.path.join(s2_root, "*")) if os.path.isdir(d))
    if not chip_dirs:
        raise SystemExit(f"no chips under {s2_root}")
    available = sorted({os.path.splitext(os.path.basename(p))[0]
                        for d in chip_dirs[:50] for p in glob.glob(os.path.join(d, "*.png"))})
    pool = args.bands if args.bands else available
    print(f"band pool: {pool}")
    candidates = enumerate_orders(pool, cpf, args.max_candidates)
    if not candidates:
        raise SystemExit(f"no band arrangement of {pool} has width {cpf}")
    print(f"{len(candidates)} candidate orders")

    # the scored chips, gathered once (the stacks differ per candidate, the GT does not)
    chips = []
    for d in chip_dirs:
        chip = os.path.basename(d)
        naip = glob.glob(os.path.join(args.data_root, "naip", chip, "*.png"))
        if not naip:
            continue
        chips.append((d, read_png(naip[0])))
        if len(chips) >= args.limit:
            break
    if not chips:
        raise SystemExit("no (sentinel2, naip) chip pairs found")

    rows = []
    for ci, bands in enumerate(candidates):
        stacks, gts = [], []
        for d, gt in chips:
            s = load_stack(d, bands, args.n_frames)
            if s is not None:
                stacks.append(s)
                gts.append(gt)
        if not stacks:
            continue
        sr = super_resolve(model, np.stack(stacks), device)
        psnrs = [calculate_psnr(sr[i], gts[i], crop_border=4) for i in range(len(gts))]
        rows.append({"bands": bands, "psnr": float(np.mean(psnrs)), "chips": len(gts)})
        print(f"  [{ci + 1}/{len(candidates)}] {','.join(bands):<40} "
              f"PSNR {rows[-1]['psnr']:.3f} dB", flush=True)

    rows.sort(key=lambda r: -r["psnr"])
    best = rows[0]
    margin = best["psnr"] - rows[1]["psnr"] if len(rows) > 1 else float("inf")
    print(f"\nwinner: {best['bands']}  ({best['psnr']:.3f} dB, "
          f"margin {margin:+.3f} dB over runner-up)")
    print("paste into your config:")
    print("  s2_bands: [" + ", ".join(best["bands"]) + "]")
    if margin < 0.5 and len(rows) > 1:
        print("WARNING: margin < 0.5 dB — rerun with a larger --limit before trusting this order")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"checkpoint": os.path.basename(args.checkpoint), "num_in_ch": num_in_ch,
                       "n_frames": args.n_frames, "winner": best["bands"], "margin_db": margin,
                       "ranking": rows}, f, indent=2)
        print(f"report written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

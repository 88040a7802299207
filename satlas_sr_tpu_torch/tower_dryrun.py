"""One-pass import dry-run for user-mounted pretrained tower weights (the JAX
package's scripts/tower_dryrun.py, on the port's importers and towers).

    python -m satlas_sr_tpu_torch.tower_dryrun weights/ [--out TOWER_DRYRUN.json]
        [--clip-models RN50 ...] [--max-forward-params 3e8] [--device cuda]

Point it at a directory of .pth/.pt/.bin files: it reports, per file, which
tower families import, with parameter counts and a forward fingerprint, in
one pass, so a first session with real weights spends no time debugging
importers. Families tried per file (the entry points the losses and
metrics use):
  vgg19        losses/vgg.py torchvision VGG19 features (perceptual_opt)
  lpips-vgg    metrics/lpips.py lpips-package vgg checkpoint
  lpips-alex   metrics/lpips.py lpips-package alex checkpoint
  CLIP towers  metrics/clip_encoder.py: OpenAI CLIP visual, open_clip
               SigLIP visual.trunk, bare timm ViT, timm Eva, CLIP RN50;
               one attempt per --clip-models spec
Forwards run on `--device` (the card by default) in float32 with TF32 off,
on a fixed seeded input, so two sessions can compare fingerprints; towers
above --max-forward-params skip the forward and fingerprint the parameter
tree instead. Exit 0 when every file imported as at least one family, 2
otherwise.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import sys

import numpy as np
import torch

from .device import resolve_device
from .inference import _precision

DEFAULT_CLIP_MODELS = ["EVA02-E-14-plus", "ViT-B-16-SigLIP-256", "RN50", "clip-ViT-B/16",
                       "clipa-ViT-bigG-14", "siglip-ViT-SO400M-14"]


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "size") and not isinstance(tree, (int, float)):
        yield np.asarray(tree)


def _n_params(tree) -> int:
    return int(sum(a.size for a in _leaves(tree)))


def _fingerprint_array(arr) -> str:
    a = np.asarray(arr, np.float64).ravel()
    digest = hashlib.sha256(np.round(a, 4).tobytes()).hexdigest()[:12]
    return f"{digest} (mean {a.mean():+.5f}, std {a.std():.5f})"


def _fingerprint_tree(tree) -> str:
    h = hashlib.sha256()
    for leaf in _leaves(tree):
        h.update(np.round(np.asarray(leaf, np.float64), 4).tobytes())
    return f"params:{h.hexdigest()[:12]}"


def _try_vgg19(path, state, max_fwd, device):
    from .losses.vgg import load_vgg19_from_torch, torch_params, vgg19_features

    try:
        params = load_vgg19_from_torch(path)
    except Exception:  # noqa: BLE001 - not a vgg19 file
        return None
    n = _n_params(params)
    rec = {"tower": "vgg19", "n_params": n}
    if n <= max_fwd:
        x = torch.from_numpy(np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32))
        with torch.no_grad():
            taps = vgg19_features(torch_params(params, device), x.to(device), ["conv5_4"])
        rec["fingerprint"] = _fingerprint_array(taps["conv5_4"].permute(0, 2, 3, 1).cpu())
    else:
        rec["fingerprint"] = _fingerprint_tree(params)
    return rec


def _try_lpips(path, state, flavor, max_fwd, device):
    from .metrics.lpips import _PLANS, _load_lpips_torch, calculate_lpips

    try:
        loaded = _load_lpips_torch(path, _PLANS[flavor])
    except Exception:  # noqa: BLE001
        return None
    if loaded is None:
        return None
    convs, lins = loaded
    if not lins:  # a bare torchvision backbone is vgg19's business, not lpips
        return None
    rec = {"tower": f"lpips-{flavor}", "n_params": _n_params(convs) + _n_params(lins)}
    if rec["n_params"] <= max_fwd:
        rng = np.random.RandomState(0)
        a = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        b = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        d = calculate_lpips(a, b, lpips_model=flavor, lpips_weights_path=path, device=device)
        rec["fingerprint"] = f"lpips(a,b)={d:.6f}"
    else:
        rec["fingerprint"] = _fingerprint_tree(convs)
    return rec


def _try_clip(path, state, model_name, max_fwd, device):
    from .metrics import clip_encoder as ce

    spec = ce.MODEL_SPECS[model_name]
    try:
        if isinstance(spec, ce.ResNetSpec):
            params = ce._import_clip_rn(state, spec)
        elif any(k.startswith("visual.conv1") for k in state):
            params = ce._import_openai_clip(state, spec)
        elif any(k.startswith("visual.trunk.patch_embed") for k in state):
            params = (ce._import_timm_eva(state, spec, "visual.trunk.")
                      if ce._is_eva_family(state, "visual.trunk.")
                      else ce._import_timm_vit(state, spec, "visual.trunk."))
        elif any(k.startswith("patch_embed.proj") for k in state):
            params = (ce._import_timm_eva(state, spec, "")
                      if ce._is_eva_family(state, "")
                      else ce._import_timm_vit(state, spec, ""))
        else:
            return None
    except ce.TowerImportError as e:
        # the naming family was found but the layout does not fit this spec
        return {"tower": f"clip:{model_name}", "family_detected": True, "error": str(e)}
    except Exception:  # noqa: BLE001 - shape mismatch etc: not this spec
        return None
    if params is None:
        return None
    n = _n_params(params)
    rec = {"tower": f"clip:{model_name}", "n_params": n}
    if n <= max_fwd:
        s = spec.image_size
        x = torch.from_numpy(np.random.RandomState(0).rand(1, s, s, 3).astype(np.float32))
        with torch.no_grad():
            emb = ce.tower_from_params(spec, params, device=device)(x.to(device))
        rec["fingerprint"] = _fingerprint_array(emb.cpu())
    else:
        rec["fingerprint"] = _fingerprint_tree(params)
        rec["forward_skipped"] = "> max_forward_params"
    return rec


def dry_run(weights_dir: str, clip_models, max_forward_params: float, device="cuda"):
    """(report rows, all imported) for every tower file under `weights_dir`;
    prints a line per match as it goes."""
    device = str(resolve_device(device))
    files = sorted(p for ext in ("pth", "pt", "bin")
                   for p in glob.glob(os.path.join(weights_dir, "**", f"*.{ext}"),
                                      recursive=True))
    report, all_matched = [], True
    for path in files:
        rel = os.path.relpath(path, weights_dir)
        print(f"== {rel}", flush=True)
        try:
            state = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(state, dict) and "state_dict" in state:
                state = state["state_dict"]
        except Exception as e:  # noqa: BLE001 - undecodable file
            print(f"   UNREADABLE: {e}")
            report.append({"file": rel, "error": f"unreadable: {e}"})
            all_matched = False
            continue
        matches = []
        with _precision("highest"):  # TF32 off: fingerprints comparable across devices
            tries = [_try_vgg19(path, state, max_forward_params, device),
                     _try_lpips(path, state, "vgg", max_forward_params, device),
                     _try_lpips(path, state, "alex", max_forward_params, device),
                     *[_try_clip(path, state, m, max_forward_params, device)
                       for m in clip_models]]
        for rec in tries:
            if rec is not None:
                matches.append(rec)
                tag = rec.get("fingerprint", rec.get("error", ""))
                n = rec.get("n_params")
                print(f"   {rec['tower']:<28} {f'{n:,} params  ' if n else ''}{tag}")
        full = [m for m in matches if "error" not in m]
        if not full:
            all_matched = False
            print("   NO MATCH: none of the known naming families imported this file"
                  + (" (family detected but layout unsupported — see above)" if matches else ""))
        report.append({"file": rel, "matches": matches, "imported": bool(full)})
    return files, report, all_matched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="report import status of every tower weights file in a directory, "
                    "in one pass")
    ap.add_argument("weights_dir")
    ap.add_argument("--clip-models", nargs="*", default=DEFAULT_CLIP_MODELS,
                    help="CLIP specs to try (metrics/clip_encoder.py MODEL_SPECS names)")
    ap.add_argument("--max-forward-params", type=float, default=3e8,
                    help="skip the forward fingerprint above this many parameters "
                         "(EVA02-E: 4.4B)")
    ap.add_argument("--out", default=None, help="write the report JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    files, report, all_matched = dry_run(args.weights_dir, args.clip_models,
                                         args.max_forward_params, args.device)
    if not files:
        print(f"no .pth/.pt/.bin files under {args.weights_dir}", file=sys.stderr)
        return 2
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"weights_dir": args.weights_dir, "files": report,
                       "all_imported": all_matched}, f, indent=2)
        print(f"report written to {args.out}")
    print("DRYRUN:", "ALL IMPORTED" if all_matched else "GAPS FOUND")
    return 0 if all_matched else 2


if __name__ == "__main__":
    sys.exit(main())

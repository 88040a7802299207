"""Artifact fetch CLI: the S2-NAIP datasets and released model weights.

A copy of satlas_sr_tpu/fetch.py (stdlib only), so that the port fetches
without the JAX package. The reference distributes its data and
checkpoints as a README section of bare hyperlinks the user is expected to
click and un-tar by hand (reference README.md:33-60 "Download",
README.md:62-87 "Model Weights"). This module turns that page into a
machine-readable artifact registry plus a downloader the rest of the port
(doctor, acceptance) can point at:

    python -m satlas_sr_tpu_torch.fetch list
    python -m satlas_sr_tpu_torch.fetch get val_set --dest data
    python -m satlas_sr_tpu_torch.fetch get esrgan_8S2 srcnn --dest weights

Beyond the reference's click-the-links instructions:
- resumable downloads: HTTP Range over a `.part` file, atomic rename on
  completion, so a dropped 100 GB train-set transfer continues where it died;
- bounded retry with backoff on transient network errors;
- sha256 verification (`--sha256`; the upstream publishes no digests, so
  the registry pins none: pass one when your mirror does);
- safe tar extraction: absolute paths, `..` traversal and link members are
  refused (stdlib extractall trusts the archive);
- multi-part artifacts (train_urban_set ships as four 7z volumes) fetch
  part-by-part, each independently resumable;
- `--url` substitutes a private mirror for any artifact name.

Zero-egress environments get a clean per-URL error message instead of a
stack trace, so artifacts can be mirrored in by hand and re-checked with
`get --no-download` (verify/extract an already-present file).

7z volumes are NOT auto-extracted (no 7z codec in the stdlib); the CLI
prints the exact `7z x` command instead. Tars extract natively.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tarfile
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

_R2A = "https://pub-25c498004d1e4d4c8da69b2c05676836.r2.dev"
_R2B = "https://pub-956f3eb0f5974f37b9228e0a62f449bf.r2.dev/satlas_explorer_datasets"

# name -> {urls, kind (tar|7z|file), about}. URLs transcribed from the
# reference README Download + Model Weights tables (README.md:33-87).
REGISTRY: Dict[str, Dict] = {
    # --- datasets (README.md:33-57) ---
    "train_urban_set": {
        "urls": [f"{_R2A}/train_urban_set.7z.{i:03d}" for i in (1, 2, 3, 4)],
        "kind": "7z",
        "about": "1.1M-pair training set, urban USA, 12 S2 bands (4 7z volumes)",
    },
    "train_full_set": {
        "urls": [f"{_R2B}/super_resolution_train-full-set_2023-12-01.tar"],
        "kind": "tar",
        "about": "full training set, tci only (very large)",
    },
    "val_set": {
        "urls": [f"{_R2A}/super_resolution_val_set_2024-01-09.tar"],
        "kind": "tar",
        "about": "8192 validation pairs, 12 S2 bands",
    },
    "small_val_set": {
        "urls": [f"{_R2A}/super_resolution_small_val_set_2024-01-09.tar"],
        "kind": "tar",
        "about": "256-pair urban validation subset (fast val)",
    },
    "test_set": {
        "urls": [f"{_R2A}/super_resolution_test_set_2024-01-09.tar"],
        "kind": "tar",
        "about": "8 test tiles as 16x16 chunk grids (infer_grid input)",
    },
    "old_naip": {
        "urls": [f"{_R2A}/old_naip.tar"],
        "kind": "tar",
        "about": "2016-18 NAIP for the old-naip discriminator variant",
    },
    "train_tile_weights": {
        "urls": [f"{_R2A}/super_resolution_train_tile_weights.tar"],
        "kind": "tar",
        "about": "inverse-OSM-frequency tile weights (data.tile_weights key)",
    },
    "osm_chips_to_masks": {
        "urls": [f"{_R2A}/osm_chips_to_masks.json"],
        "kind": "file",
        "about": "chip -> OSM polygons json (OSMObjESRGANModel)",
    },
    "satlas_rrdbnet": {
        "urls": [f"{_R2A}/satlas_rrdbnet.pth"],
        "kind": "file",
        "about": "RRDBNet pretrained on SatlasPretrain (warm-start variant)",
    },
    # --- released checkpoints (README.md:66-87) ---
    **{
        f"esrgan_{n}S2": {
            "urls": [f"{_R2A}/esrgan_{n}S2.pth"],
            "kind": "file",
            "about": f"ESRGAN generator, {n} input S2 image(s), tci bands",
        }
        for n in (1, 2, 4, 8, 16)
    },
    **{
        f"esrgan_{b}": {
            "urls": [f"{_R2A}/esrgan_{b}.pth"],
            "kind": "file",
            "about": f"ESRGAN generator, 8 input images, {b} S2 bands",
        }
        for b in ("10m", "20m", "60m")
    },
    "srcnn": {
        "urls": [f"{_R2B}/super_resolution_models/srcnn_s2naip.pth"],
        "kind": "file",
        "about": "SRCNN trained on S2-NAIP (L2Model)",
    },
    "highresnet": {
        "urls": [f"{_R2B}/super_resolution_models/highresnet_s2naip.pth"],
        "kind": "file",
        "about": "HighResNet trained on S2-NAIP (L2Model)",
    },
}


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def download(url: str, dest: str, *, resume: bool = True, retries: int = 3,
             timeout: float = 30.0, backoff: float = 1.0,
             progress: bool = True, _sleep=time.sleep) -> str:
    """Fetch url -> dest, resuming an interrupted transfer via a .part file.

    The partial transfer lives at `dest + '.part'` and is atomically renamed
    into place only once complete, so `dest` existing means the bytes are
    whole. Returns dest. Raises OSError with the failing URL after retries.
    """
    if os.path.exists(dest):
        return dest  # complete (atomic rename is the completion marker)
    part = dest + ".part"
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)

    last_err: Optional[Exception] = None
    for attempt in range(retries):
        have = os.path.getsize(part) if (resume and os.path.exists(part)) else 0
        req = urllib.request.Request(url)
        if have:
            req.add_header("Range", f"bytes={have}-")
        try:
            try:
                resp_ctx = urllib.request.urlopen(req, timeout=timeout)
            except urllib.error.HTTPError as e:
                if e.code == 416 and have:
                    # Range past the end: the .part already holds the full
                    # body (killed between the last write and the rename).
                    # Promote it instead of retrying the same header forever.
                    os.replace(part, dest)
                    return dest
                raise
            with resp_ctx as resp:
                status = getattr(resp, "status", resp.getcode())
                if have and status != 206:
                    # server ignored Range (or file changed): restart clean
                    have = 0
                mode = "ab" if have else "wb"
                total = resp.headers.get("Content-Length")
                total_n = (int(total) + have) if total else None
                done = have
                with open(part, mode) as out:
                    while True:
                        chunk = resp.read(1 << 20)
                        if not chunk:
                            break
                        out.write(chunk)
                        done += len(chunk)
                        if progress and total_n:
                            pct = 100.0 * done / max(total_n, 1)
                            print(f"\r  {os.path.basename(dest)}: "
                                  f"{done / 1e6:.1f}/{total_n / 1e6:.1f} MB "
                                  f"({pct:.0f}%)", end="", file=sys.stderr)
                if progress and total_n:
                    print(file=sys.stderr)
                if total_n is not None and done < total_n:
                    raise OSError(f"short read: {done} < {total_n} bytes")
            os.replace(part, dest)
            return dest
        except (urllib.error.URLError, OSError, ValueError) as e:
            last_err = e
            if attempt + 1 < retries:
                _sleep(backoff * (2 ** attempt))
    raise OSError(f"download failed after {retries} attempts: {url}\n"
                  f"  last error: {last_err}\n"
                  f"  (no egress here? mirror the file to the --dest dir "
                  f"by hand, then re-run with --no-download)")


def safe_extract_tar(tar_path: str, dest_dir: str) -> int:
    """Extract tar_path under dest_dir, refusing traversal/link members.

    stdlib extractall trusts archive member names; a hostile mirror could
    plant `../../ssh/authorized_keys`. Returns the member count extracted.
    """
    n = 0
    dest_real = os.path.realpath(dest_dir)
    with tarfile.open(tar_path) as tf:
        for m in tf:
            if m.issym() or m.islnk():
                raise ValueError(f"refusing link member in archive: {m.name}")
            target = os.path.realpath(os.path.join(dest_real, m.name))
            if target != dest_real and not target.startswith(dest_real + os.sep):
                raise ValueError(f"refusing path-traversal member: {m.name}")
            try:
                tf.extract(m, dest_real, filter="data")
            except TypeError:  # Python < 3.12 without the filter kwarg
                tf.extract(m, dest_real)
            n += 1
    return n


def fetch_artifact(name: str, dest_dir: str, *, extract: bool = True,
                   sha256: Optional[str] = None, url: Optional[str] = None,
                   no_download: bool = False, retries: int = 3,
                   progress: bool = True) -> List[str]:
    """Fetch (and optionally extract) one registry artifact. Returns the
    local file paths produced."""
    if name not in REGISTRY:
        raise KeyError(f"unknown artifact {name!r}; see `fetch list` "
                       f"(known: {', '.join(sorted(REGISTRY))})")
    entry = REGISTRY[name]
    urls = [url] if url else entry["urls"]
    if url and len(entry["urls"]) > 1:
        raise ValueError(f"{name} is a {len(entry['urls'])}-part artifact; "
                         f"--url only supports single-part overrides")
    paths: List[str] = []
    for u in urls:
        # basename of the URL *path* — presigned mirror URLs carry query
        # strings (auth tokens) that must reach neither the filename nor disk
        local = os.path.join(
            dest_dir, os.path.basename(urllib.parse.urlsplit(u).path))
        if no_download:
            if not os.path.exists(local):
                raise FileNotFoundError(
                    f"--no-download but {local} is absent (mirror it in "
                    f"from {u})")
        else:
            download(u, local, retries=retries, progress=progress)
        paths.append(local)

    if sha256 is not None:
        if len(paths) != 1:
            raise ValueError("--sha256 applies to single-file artifacts only")
        got = sha256_file(paths[0])
        if got != sha256.lower():
            raise ValueError(f"sha256 mismatch for {paths[0]}:\n"
                             f"  expected {sha256.lower()}\n  got      {got}")

    if extract and entry["kind"] == "tar":
        for p in paths:
            # extraction marker: re-running `fetch get` on a multi-GB tar
            # must be O(1), not a full re-extract over the existing tree
            marker = p + ".extracted"
            if os.path.exists(marker):
                print(f"{os.path.basename(p)}: already extracted "
                      f"(remove {marker} to force)")
                continue
            n = safe_extract_tar(p, dest_dir)
            with open(marker, "w") as f:
                f.write(f"members={n}\n")
            print(f"extracted {n} members from {os.path.basename(p)} "
                  f"into {dest_dir}")
    elif entry["kind"] == "7z":
        vol = os.path.basename(paths[0])
        print(f"{name}: 7z volumes downloaded; extract with:\n"
              f"  7z x {os.path.join(dest_dir, vol)}")
    return paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="fetch S2-NAIP data / released weights "
                    "(registry mirrors the reference README)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list known artifacts")
    g = sub.add_parser("get", help="download artifacts")
    g.add_argument("names", nargs="+", help="artifact names (see `list`)")
    g.add_argument("--dest", default=".", help="destination directory")
    g.add_argument("--no-extract", action="store_true",
                   help="keep archives unextracted")
    g.add_argument("--no-download", action="store_true",
                   help="verify/extract already-mirrored files only")
    g.add_argument("--sha256", default=None,
                   help="expected digest (single-file artifacts)")
    g.add_argument("--url", default=None,
                   help="override the registry URL (private mirror)")
    g.add_argument("--retries", type=int, default=3)
    args = parser.parse_args(argv)

    if args.cmd == "list":
        w = max(len(n) for n in REGISTRY)
        for n in sorted(REGISTRY):
            e = REGISTRY[n]
            parts = f" [{len(e['urls'])} parts]" if len(e["urls"]) > 1 else ""
            print(f"{n:<{w}}  {e['kind']:<4}{parts}  {e['about']}")
        return 0

    if (args.sha256 or args.url) and len(args.names) > 1:
        print("--sha256/--url apply to a single artifact", file=sys.stderr)
        return 2
    rc = 0
    for name in args.names:
        try:
            fetch_artifact(name, args.dest, extract=not args.no_extract,
                           sha256=args.sha256, url=args.url,
                           no_download=args.no_download, retries=args.retries)
        except (KeyError, ValueError, OSError) as e:
            print(f"error fetching {name}: {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())

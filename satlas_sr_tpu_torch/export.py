"""Export of the SR program to a deployable `.ssrx` artifact, on the card.

Counterpart of satlas_sr_tpu/export.py. `torch.export` traces the
InferenceEngine's uint8 -> uint8 function once (`inference.UInt8Program`),
the weights embedded in the program, into a self-contained `.ssrx` file. A
deployment host loads it with ExportedEngine and needs neither the model
code nor the checkpoint import path: it runs the graph that was checked.
It does need the port's op library, `ops/cuda/rdb.py`, which registers the
`satlas_sr_torch::rdb` op (the hand-written RDB kernel on CUDA, its plain
version on the CPU); the traced graph calls that op, and the exported
program launches the kernel. (The JAX artifact needs no code of its
package at all: its kernel is lowered into the StableHLO.) The programs are
not AOTInductor shared objects: the op is bound through ctypes and Python,
which a compiled `.so` could not call.

Artifact (`.ssrx`) = a zip of:
  meta.json                    model/config/shape/platform metadata
  {platform}/module.pt2        torch.export.save of the ExportedProgram
  {platform}/module_b{N}.pt2   extra fixed-batch programs (`--buckets`): the
                               serving daemon's batch-shape buckets
                               (serve.py), shipped ready, so an
                               artifact-backed daemon keeps its small-batch
                               dispatch.
One set of programs per platform (`cuda`, `cpu`): the frozen RDB weights
are held in the layout of the device that runs them (the kernel's packed
layout on CUDA, OIHW on the CPU). The .pt2 entries are stored, not
deflated: each is a zip already. The format tag is ssrx-torch-v1; a JAX
artifact (ssrx-v1) is refused by name, and the JAX reader refuses this one.

`--symbolic_batch` exports the batch axis as a torch.export.Dim of at most
65535 (the kernel's grid limit): any batch size, one artifact. Exporting
for `cuda` needs a card (the weights are packed there); the loader runs an
artifact only on a device type that meta["platforms"] lists, and applies
meta["matmul_precision"] around every call (a program does not carry the
process's TF32 flags).

Usage:
  python -m satlas_sr_tpu_torch.export -opt options/infer_example.yml -o model.ssrx --check
  python -m satlas_sr_tpu_torch.serve  -opt options/infer_example.yml --artifact model.ssrx
"""

from __future__ import annotations

import argparse
import io
import json
import os
import zipfile
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .inference import BatchRunner
from .ops.cuda import rdb as _rdb_ops  # noqa: F401 - registers satlas_sr_torch::rdb

ARTIFACT_FORMAT = "ssrx-torch-v1"
JAX_ARTIFACT_FORMAT = "ssrx-v1"
PLATFORMS = ("cuda", "cpu")
MAX_BATCH = 65535  # the rdb kernel's grid limit (ops/cuda/rdb.py _launch)
_META_NAME = "meta.json"
_MODULE_NAME = "{}/module.pt2"
_MODULE_NAME_BUCKET = "{}/module_b{}.pt2"


def _export_program(program: torch.nn.Module, example: torch.Tensor, symbolic: bool) -> bytes:
    dynamic = {"x_uint8": {0: torch.export.Dim("b", min=1, max=MAX_BATCH)}} if symbolic else None
    exported = torch.export.export(program, (example,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def export_artifact(
    opt: dict,
    out_path: str,
    batch_size: Optional[int] = None,
    symbolic_batch: bool = False,
    hw: int = 32,
    platforms: Sequence[str] = PLATFORMS,
    check: bool = False,
    buckets: Optional[Sequence[int]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Trace the engine program for `opt` and write a `.ssrx` artifact.

    The live engine is built on `device`; one program set is traced per
    entry of `platforms` (see the module docstring). `symbolic_batch=True`
    exports a batch-polymorphic program. `hw` sets the square input window
    (32 = the chunk/serving shape). `buckets` adds one program per extra
    batch shape (deduped, capped at the full batch). `check` reloads the
    artifact and holds it bit-exact against the live engine on `device`, at
    the full batch and at each bucket at its own shape; the artifact is
    written to `out_path + '.tmp'` and renamed only after the check passed.
    Returns the artifact metadata dict.
    """
    from .archs.rrdbnet import freeze_rdbs
    from .infer import load_infer_variables
    from .inference import InferenceEngine, UInt8Program
    from .utils.model_utils import build_network, uses_3d_input

    device = resolve_device(device)
    platforms = list(dict.fromkeys(platforms))
    unknown = [p for p in platforms if p not in PLATFORMS]
    if not platforms or unknown:
        raise ValueError(f"platforms must be among {list(PLATFORMS)}, got {platforms}")
    if "cuda" in platforms:
        resolve_device("cuda")  # the kernel's packed weights are made on a card
    if buckets and symbolic_batch:
        raise ValueError(
            "--buckets only applies to fixed-batch exports; a symbolic-batch "
            "artifact already serves any batch size")

    n_frames = int(opt["n_lr_images"])
    use_3d = uses_3d_input(opt["network_g"]["type"])
    model = build_network(opt, device="cpu")
    variables = load_infer_variables(opt, model)
    precision = str(opt.get("matmul_precision", "highest"))
    engine = InferenceEngine(model, variables,
                             batch_size=int(batch_size or opt.get("batch_size", 64)),
                             use_3d=use_3d, n_frames=n_frames, matmul_precision=precision,
                             device=device)
    dims = (n_frames, hw, hw, 3) if use_3d else (hw, hw, n_frames * 3)

    bucket_sizes = []
    if buckets:
        bucket_sizes = sorted({engine.round_bucket(int(b)) for b in buckets} | {engine.batch_size})
    payloads: Dict[str, bytes] = {}
    for platform in platforms:
        program = UInt8Program(freeze_rdbs(engine.model, device=platform), engine.dtype).eval()
        # a batch of 1 would be specialised by the tracer, not kept symbolic
        b = max(2, engine.batch_size) if symbolic_batch else engine.batch_size
        example = torch.zeros((b,) + dims, dtype=torch.uint8, device=platform)
        payloads[_MODULE_NAME.format(platform)] = _export_program(program, example, symbolic_batch)
        for b in bucket_sizes:
            if b != engine.batch_size:  # the primary program already has this shape
                example = torch.zeros((b,) + dims, dtype=torch.uint8, device=platform)
                payloads[_MODULE_NAME_BUCKET.format(platform, b)] = _export_program(
                    program, example, False)
        del program

    meta: Dict[str, Any] = {
        "format": ARTIFACT_FORMAT,
        "model_type": opt["network_g"]["type"],
        "network_g": dict(opt["network_g"]),
        "scale": int(opt.get("scale", opt["network_g"].get("scale", 4))),
        "n_lr_images": n_frames,
        "use_3d": use_3d,
        "batch_size": None if symbolic_batch else engine.batch_size,
        "input_dims": list(dims),
        "input_dtype": "uint8",
        "output_dtype": "uint8",
        "platforms": platforms,
        "matmul_precision": precision,
        "compute_dtype": str(engine.dtype).removeprefix("torch."),
        "torch_version": torch.__version__,
        "calling_convention": "torch.export ExportedProgram: x_uint8 -> uint8",
        "weights": opt.get("path", {}).get("pretrain_network_g") or "(seeded init)",
    }
    if bucket_sizes:
        meta["bucket_batches"] = bucket_sizes
    will_check = check and device.type in platforms
    if check and not will_check:
        print(f"check skipped: the engine's device '{device.type}' not in exported "
              f"platforms {platforms}")
    meta["checked"] = will_check

    tmp_path = out_path + ".tmp"
    with zipfile.ZipFile(tmp_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_META_NAME, json.dumps(meta, indent=1))
        for name, payload in payloads.items():
            z.writestr(name, payload, compress_type=zipfile.ZIP_STORED)
    del payloads
    try:
        if will_check:
            loaded = ExportedEngine(tmp_path, batch_size=engine.batch_size, device=device)
            rng = np.random.RandomState(0)
            x = (rng.rand(engine.batch_size, *dims) * 255).astype(np.uint8)
            if not np.array_equal(engine.run(x), loaded.run(x)):
                raise AssertionError("exported artifact output differs from the live engine")
            # each extra bucket program against the live engine at the SAME
            # batch shape: the bit-exactness contract is per shape
            for b in bucket_sizes:
                if b == engine.batch_size:
                    continue
                xb = (rng.rand(b, *dims) * 255).astype(np.uint8)
                ref = engine.fetch(engine.dispatch(xb, bucket=b))
                got = loaded.fetch(loaded.dispatch(xb, bucket=b))
                if not np.array_equal(ref, got):
                    raise AssertionError(f"bucket-{b} program differs from the live engine")
            print(f"check ok: artifact matches the live engine bit-exactly on a random batch "
                  f"({device.type}" + (f", buckets {bucket_sizes}" if bucket_sizes else "") + ")")
        os.replace(tmp_path, out_path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
    return meta


def read_artifact_meta(path: str) -> Dict[str, Any]:
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read(_META_NAME))
    fmt = meta.get("format")
    if fmt == JAX_ARTIFACT_FORMAT:
        raise ValueError(
            f"{path}: a JAX artifact (format {JAX_ARTIFACT_FORMAT!r}, jax.export StableHLO), "
            f"which this package does not run; it reads {ARTIFACT_FORMAT!r} (torch.export "
            "programs): re-export with python -m satlas_sr_tpu_torch.export")
    if fmt != ARTIFACT_FORMAT:
        raise ValueError(f"{path}: unsupported artifact format {fmt!r} "
                         f"(expected {ARTIFACT_FORMAT})")
    return meta


class ExportedEngine(BatchRunner):
    """Drop-in InferenceEngine replacement backed by a `.ssrx` artifact.

    The same `batch_size` / `round_bucket` / `run` / `dispatch` / `fetch` /
    `run_many` surface the serving daemon and the CLIs program against, from
    torch.export programs: the host needs the port's op library but no
    model code. It runs only on a device type the artifact lists (no
    fallback to another). For symbolic-batch artifacts `batch_size` fixes
    the serving batch; other sizes run the same program.
    """

    def __init__(self, path: str, batch_size: Optional[int] = None,
                 default_batch_size: Optional[int] = None, device="cuda"):
        device = resolve_device(device)
        self.meta = read_artifact_meta(path)
        platforms = list(self.meta["platforms"])
        if device.type not in platforms:
            raise RuntimeError(
                f"{path} was exported for {platforms}; this engine's device is "
                f"'{device.type}'. Re-export with --platforms {device.type} (or including it).")
        # Precedence: explicit request > the artifact's pinned batch >
        # caller's default (serve passes the config's batch_size) > 64.
        fixed = self.meta.get("batch_size")
        self.fixed_batch = fixed is not None
        batch = int(batch_size or fixed or default_batch_size or 64)
        if fixed is not None and batch != int(fixed):
            raise ValueError(
                f"artifact has a fixed batch of {fixed}; requested {batch} (use a "
                "--symbolic_batch export for variable batch sizes)")
        sizes = [int(b) for b in self.meta.get("bucket_batches", [])]
        with zipfile.ZipFile(path) as z:
            names = {_MODULE_NAME_BUCKET.format(device.type, b): b for b in sizes}
            blobs = {batch: z.read(_MODULE_NAME.format(device.type))}
            blobs.update({b: z.read(n) for n, b in names.items()
                          if n in z.namelist() and b != batch})
        self._programs = {b: torch.export.load(io.BytesIO(blob)).module()
                          for b, blob in blobs.items()}
        del blobs
        self._bucket_sizes = sorted(self._programs)
        super().__init__(device, batch, bool(self.meta["use_3d"]), int(self.meta["n_lr_images"]),
                         str(self.meta["matmul_precision"]))

    def round_bucket(self, b: int) -> int:
        """Smallest shipped batch shape >= b. Fixed-batch artifacts carry their
        `bucket_batches` programs (the full batch alone for single-shape
        exports); a symbolic-batch program runs any size."""
        if self.fixed_batch:
            for size in self._bucket_sizes:
                if size >= int(b):
                    return size
            return self.batch_size
        return super().round_bucket(b)

    def dispatch(self, batch_np: np.ndarray, bucket: Optional[int] = None):
        if self.fixed_batch:  # only shipped shapes exist
            bucket = self.round_bucket(bucket) if bucket else self.batch_size
        return super().dispatch(batch_np, bucket)

    def _call(self, x: torch.Tensor, bucket: int) -> torch.Tensor:
        return self._programs[bucket if bucket in self._programs else self.batch_size](x)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-opt", type=str, required=True,
                        help="Path to an infer-style options yml.")
    parser.add_argument("-o", "--out", type=str, required=True,
                        help="Output artifact path (.ssrx).")
    parser.add_argument("--batch", type=int, default=None,
                        help="Fixed batch size (default: config batch_size).")
    parser.add_argument("--symbolic_batch", action="store_true",
                        help="Export a batch-polymorphic program instead.")
    parser.add_argument("--hw", type=int, default=32,
                        help="Square input window (32 = chunk/serving shape).")
    parser.add_argument("--platforms", type=str, default="cuda,cpu",
                        help="Comma-separated device types to export programs for.")
    parser.add_argument("--check", action="store_true",
                        help="Reload the artifact and verify bit-exact against the live engine.")
    parser.add_argument("--buckets", type=str, default="none",
                        help="Extra fixed-batch programs to ship for the serving daemon's "
                             "bucket dispatch: comma ints, 'auto' (batch/8, matching serve "
                             "--buckets auto), or 'none'.")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from .utils.lint import report_lint
    from .utils.options import yaml_load

    opt = yaml_load(args.opt)
    report_lint(opt, "infer")
    batch = int(args.batch or opt.get("batch_size", 64))
    buckets = None
    if args.buckets == "auto":
        buckets = [batch // 8] if batch >= 8 else None
    elif args.buckets not in ("none", ""):
        buckets = [int(b) for b in args.buckets.split(",") if b.strip()]
    meta = export_artifact(
        opt, args.out, batch_size=args.batch, symbolic_batch=args.symbolic_batch, hw=args.hw,
        platforms=[p.strip() for p in args.platforms.split(",") if p.strip()],
        check=args.check, buckets=buckets, device=args.device)
    print(f"exported {meta['model_type']} -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB, platforms {meta['platforms']}, batch "
          f"{meta['batch_size'] if meta['batch_size'] else 'symbolic'}"
          + (f", buckets {meta['bucket_batches']}" if meta.get("bucket_batches") else "") + ")")


if __name__ == "__main__":
    main()

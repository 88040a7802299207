"""Runs one cell once and builds its result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name BENCHMARK.json gives it:
- configs/<config>.json: the configuration as run (its `file` entry);
- traffic/<traffic>.json: the mix's parameters, whose `kind` names the
  general driver that reads them (kinds/<kind>.py);
- cells/<workload>.json: the limits `correct` holds the cell to;
- metrics/<metric>.py: `read(ctx)`, which returns the metric's value from
  the run's context, or None when it finds nothing to read (the metric is
  then left out of the line).
A driver's `run(cell, seed, seconds, trace, device)` returns a Run: the
context the readers read, the counts, the numbers `correct` compares.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import correct as correct_mod
from . import guard

BENCH_DIR = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    root: Path                      # the checkout: BENCHMARK.json's directory
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]  # the entries this cell reports
    per_layer: List[Dict[str, Any]]

    @property
    def bench_dir(self) -> Path:
        return self.root / "portbench"


@dataclass
class Run:
    ctx: Dict[str, Any]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak_bytes: int
    device_kind: str
    device_count: int = 1
    trace: Any = None               # trace.Trace of the traced stretch, or None
    notes: List[str] = field(default_factory=list)


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, its files read."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in spec["workloads"]}
    if workload not in wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = wl[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "portbench"
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name=workload, root=root,
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
                limits=json.loads((bench / "cells" / f"{workload}.json").read_text())["limits"],
                end_to_end=e2e, per_layer=per_layer)


def reader(cell: Cell, metric: str):
    """metrics/<metric>.py's `read` (file names may hold dots)."""
    path = cell.bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(cell: Cell):
    return importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")


def metrics_of(cell: Cell, run: Run, trace_on: bool) -> Dict[str, Dict[str, Any]]:
    """The line's metrics: the end-to-end ones without the trace, the
    per-layer ones with it; a reader's None leaves its metric out."""
    out = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        value = reader(cell, m["name"])(run.ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: Cell, run: Run, trace_on: bool) -> Dict[str, Any]:
    """The result object; its `checks` (each compared number beside its
    limit) comes last."""
    from . import trace as trace_mod

    ok, checks = correct_mod.judge(run.numbers, cell.limits)
    device = {"platform": "cpu" if run.device_kind == "cpu" else "gpu", "kind": run.device_kind, "count": run.device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line: Dict[str, Any] = {"correct": ok and run.failed == 0, "attempted": run.attempted,
                            "failed": run.failed, "metrics": metrics_of(cell, run, trace_on),
                            "device": device}
    if trace_on and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": trace_mod.device_ops(run.trace),
                             "idle_gaps": trace_mod.idle_gaps(run.trace)}
    line["checks"] = checks
    return line


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None, device: str = "cuda",
         root: Optional[Path] = None, out=None) -> int:
    """The command line of run.py; `device` and `root` are for the tests,
    which run a cell on the CPU from a copy of the benchmark."""
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd() if root is None else root
    cell = load_cell(args.workload, root)
    import torch

    if device == "cuda":
        need = int(next(w for w in json.loads((root / "BENCHMARK.json").read_text())["workloads"]
                        if w["name"] == args.workload)["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"portbench: {need} CUDA device(s) needed, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
                  file=sys.stderr)
            return 2
    run = driver(cell).run(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    line = result_line(cell, run, bool(args.trace))
    bad = guard.forbidden()  # after the readers, which a later PR adds, have run
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for note in run.notes + [f"numbers: {json.dumps(run.numbers)}"]:
        print(note, file=sys.stderr)
    for text in correct_mod.check_lines(line["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out or sys.stdout, flush=True)
    return 0

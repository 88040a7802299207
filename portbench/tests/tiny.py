"""A copy of the benchmark at a size a CPU test holds: every file as it is,
the configurations and mixes narrowed (widths, depth, chip and batch
sizes), so a test drives the whole of a run on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    for key, value in changes.items():
        node = data
        *parents, last = key.split("__")
        for p in parents:
            node = node[p]
        node[last] = value
    path.write_text(json.dumps(data))


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json and portbench/ copied under `dest`, narrowed."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = dest / "portbench"
    edit(b / "configs/esrgan_8s2.json", network_g__num_feat=8, network_g__num_grow_ch=4,
         network_g__num_block=1, lr_size=8)
    edit(b / "traffic/batch64_f32.json", batch_size=4, pool_batches=3, trace_seconds=0.2)
    return dest


def run_cell(root: Path, workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.5,
             trace: int = 0, capsys=None):
    """harness.main on the CPU; returns (exit code, the result line or None)."""
    import io

    from portbench import harness

    out = io.StringIO()
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", root=root, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)

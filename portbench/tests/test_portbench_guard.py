"""The import guard: whole top-level names, so the port passes and the JAX
package does not; a whole run loads neither, and a run that does prints no
result."""

import json
import subprocess
import sys

from portbench import guard
from portbench.tests.tiny import ROOT


def test_names_are_compared_whole_at_the_top_level():
    assert guard.forbidden(["satlas_sr_tpu_torch", "satlas_sr_tpu_torch.ops", "jaxtyping",
                            "flaxen", "torch"]) == []
    assert guard.forbidden(["satlas_sr_tpu", "satlas_sr_tpu.ops.pallas", "jax", "jaxlib.xla",
                            "flax.linen"]) == sorted(["satlas_sr_tpu", "satlas_sr_tpu.ops.pallas",
                                                      "jax", "jaxlib.xla", "flax.linen"])


def _in_a_fresh_process(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)


def test_a_run_and_every_benchmark_module_load_no_jax(tmp_path):
    """Every module under portbench/ and every metric reader imported, then a
    whole tiny traced run of each cell, in a fresh process: nothing
    forbidden in sys.modules."""
    code = f"""
import pkgutil, importlib, sys
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
import portbench
for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):
    importlib.import_module(m.name)
from portbench.tests.tiny import tiny_copy, run_cell
from portbench import guard, harness
import json, torch; torch.set_num_threads(2)
root = tiny_copy(Path({str(tmp_path)!r}))
spec = json.loads((root / "BENCHMARK.json").read_text())
for w in spec["workloads"]:
    cell = harness.load_cell(w["name"], root)
    for m in cell.end_to_end + cell.per_layer:
        harness.reader(cell, m["name"])
    rc, line = run_cell(root, w["name"], seconds=0.3, trace=1)
    assert rc == 0 and line is not None, (w, rc)
bad = guard.forbidden()
assert not bad, bad
"""
    proc = _in_a_fresh_process(code)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_a_reader_that_loads_jax_stops_the_result(tmp_path):
    """A metric reader, added as a later PR would add one, that imports a
    module named `jax`: the check after the readers have run finds it, the
    run exits 3 and prints no result line."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    code = f"""
import json, sys
from pathlib import Path
sys.path[:0] = [{str(ROOT)!r}, {str(stub)!r}]
from portbench.tests.tiny import tiny_copy, run_cell
import torch; torch.set_num_threads(2)
root = tiny_copy(Path({str(tmp_path)!r}))
w = "infer-esrgan_8s2-b64-f32"
(root / "portbench/metrics/jax_reader.py").write_text("import jax\\n\\ndef read(ctx):\\n    return 1.0\\n")
spec = json.loads((root / "BENCHMARK.json").read_text())
spec["per_layer"].append({{"name": "jax_reader", "unit": "count", "better": "higher",
                          "source": "program_counter", "layer": "engine",
                          "moves": "infer_img_per_s", "workloads": [w]}})
(root / "BENCHMARK.json").write_text(json.dumps(spec))
assert "jax" not in sys.modules
rc, line = run_cell(root, w, seconds=0.3, trace=1)
print(json.dumps({{"rc": rc, "line": line}}))
"""
    proc = _in_a_fresh_process(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"rc": 3, "line": None}
    assert "jax" in proc.stderr

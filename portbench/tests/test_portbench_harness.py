"""The harness finds every file by name, a cell, a mix and a metric can be
added as files and entries alone, and the result line keeps its schema."""

import hashlib
import json
import re

import pytest
import torch

from portbench import harness, trace
from portbench.tests.tiny import ROOT, run_cell, tiny_copy

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = harness.load_cell(workload, ROOT)
    assert cell.traffic["kind"] == "infer"
    assert harness.driver(cell).run
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(cell, m["name"]))


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = 2 + 14 * 24
    assert cells * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                 "moves", "workloads"}
        for w in m["workloads"]:  # each listed cell reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_a_cell_mix_and_metric_are_added_as_files(tiny):
    """A dummy mix, cell and per-layer metric added to a copy: new files and
    new entries only, no existing file edited; the run reports the metric."""
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (tiny / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    b = tiny / "portbench"
    mix = json.loads((b / "traffic/batch64_f32.json").read_text())
    (b / "traffic/dummy_mix.json").write_text(json.dumps({**mix, "depth": 1}))
    (b / "cells/dummy-cell.json").write_text(json.dumps({"limits": {"worst_off_pct": 100.0}}))
    (b / "metrics/dummy_batches.py").write_text("def read(ctx):\n    return ctx.get('batches')\n")
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dummy-cell", "config": "esrgan_8s2",
                              "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"][1:3]:
        m["workloads"].append("dummy-cell")
    spec["per_layer"].append({"name": "dummy_batches", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "engine", "moves": "infer_img_per_s",
                              "workloads": ["dummy-cell"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line = run_cell(tiny, "dummy-cell", trace=1)
    assert rc == 0 and line["correct"] and line["metrics"]["dummy_batches"]["value"] > 0
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert after == before


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_result_line_schema(tiny, workload):
    rc, line = run_cell(tiny, workload, trace=0)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = harness.load_cell(workload, tiny)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.limits)


def test_traced_line_carries_device_times_and_breakdown():
    """A trace with device work gives busy_s, window_s and a breakdown of at
    most ten entries a list, named and measured."""
    tr = trace.Trace(kernels=[("k1", 0, 400), ("Memcpy HtoD", 500, 600), ("k2", 700, 1000)],
                     device_ranges={"portbench::rdb": [(0, 450)]},
                     host=[("portbench::fetch", 350, 800, True), ("cudaEventSynchronize", 360, 790, False)],
                     window_ns=(0, 1000))
    tr.busy = trace.merge([(s, t) for _, s, t in tr.kernels])
    assert tr.busy_s == pytest.approx(8e-7) and tr.window_s == pytest.approx(1e-6)
    assert trace.inside(tr, "portbench::rdb") == (pytest.approx(4e-7), pytest.approx(3e-7))
    assert trace.device_ops(tr)[0] == ["k1", pytest.approx(4e-7)]
    gaps = trace.idle_gaps(tr)
    assert gaps[0][0] == "portbench::fetch > cudaEventSynchronize"
    assert sum(s for _, s in gaps) == pytest.approx(2e-7)
    cell = harness.Cell("c", ROOT, {}, {}, {"x": 1.0}, [], [])
    run = harness.Run(ctx={}, attempted=1, failed=0, numbers={"x": 0.5}, memory_peak_bytes=1,
                      device_kind="NVIDIA H100 80GB HBM3", trace=tr)
    line = harness.result_line(cell, run, True)
    assert list(line)[-1] == "checks" and line["device"]["busy_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["platform"] == "gpu"

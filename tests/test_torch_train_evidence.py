"""The port's training-evidence harness (satlas_sr_tpu_torch/train_evidence.py)
against the JAX package's scripts/train_evidence.py, on the CPU:

- `_make_split` from RandomState(0) writes the same decoded pixels as JAX's
  (the two PNG encoders' bytes may differ);
- both families' configs, and the YAML `_write_config` writes, equal JAX's
  apart from path.experiments_root (the port names where its runs go);
- `_psnr_gate`, `_last_iter` and `load_metrics_rows` equal JAX's on the
  cases of tests/test_train_evidence_gate.py and on seeded random
  trajectories and metrics files, as one parametrised test;
- one tiny run of each family through `run_family` on the CPU (the
  builders narrowed: nf 8 and one block, D nf 8 and VGG19 to conv1_2, or
  HighResNet hidden 16; batch 2; 4 train / 2 val chips; 8 iterations) is
  preempted by SIGTERM, resumes with --auto_resume to total_iter
  (`resumed_ok`), and returns the JAX section's keys.
"""

import argparse
import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import yaml

from satlas_sr_tpu_torch import train_evidence as tev
from satlas_sr_tpu_torch.utils.imgio import read_png
from torch_threads import two_torch_threads  # noqa: F401

JAX_SCRIPT = os.path.join(os.path.dirname(__file__), os.pardir, "scripts", "train_evidence.py")
_SPEC = importlib.util.spec_from_file_location("jax_train_evidence", JAX_SCRIPT)
jax_tev = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_tev)

PORT_KEYS = {("path", "experiments_root")}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_make_split_same_pixels_as_jax(tmp_path):
    tev._make_split(str(tmp_path / "port"), 3, np.random.RandomState(0))
    jax_tev._make_split(str(tmp_path / "jax"), 3, np.random.RandomState(0))
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port") and len(files) == 6
    for name in files:
        assert np.array_equal(read_png(str(tmp_path / "port" / name)),
                              read_png(str(tmp_path / "jax" / name))), name


def _drop_port_keys(opt):
    opt = json.loads(json.dumps(opt))
    for section, key in PORT_KEYS:
        opt[section].pop(key, None)
    return opt


@pytest.mark.parametrize("family", sorted(jax_tev.FAMILIES))
def test_configs_equal_jax(family, tmp_path):
    args = (str(tmp_path), 300, 75, 75, 37)
    assert sorted(tev.FAMILIES) == sorted(jax_tev.FAMILIES)
    assert tev.FAMILIES[family](*args) == jax_tev.FAMILIES[family](*args)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got, got_name = tev._write_config(family, str(tmp_path / "port"), 300, 75, 75)
    want, want_name = jax_tev._write_config(family, str(tmp_path / "jax"), 300, 75, 75)
    got_opt, want_opt = (yaml.safe_load(open(p)) for p in (got, want))
    assert got_name == want_name and os.path.basename(got) == os.path.basename(want)
    assert got_opt["path"]["experiments_root"] == tev.EXPERIMENTS
    got_opt = json.loads(json.dumps(got_opt).replace(str(tmp_path / "port"), str(tmp_path / "jax")))
    assert _drop_port_keys(got_opt) == want_opt


def _metrics_text(rng):
    """A metrics.jsonl: train rows out of order, val rows with repeats at one
    iter, junk lines, an iter-less row."""
    lines = []
    for it in rng.permutation(np.arange(1, 12) * 7):
        lines.append(json.dumps({"iter": int(it), "l_g_pix": float(rng.rand())}))
        if rng.rand() < 0.3:
            lines.append("not json")
    for it in (25, 50, 50, 75, 75):
        lines.append(json.dumps({"iter": it, "val_dataset": "validation",
                                 "psnr": float(20 + rng.rand())}))
    lines.append(json.dumps({"epoch": 1, "note": "no iter"}))
    rng.shuffle(lines)
    return "\n".join(lines) + "\n"


GATE_CASES = [
    ("psnr_gate", [(100, 20.000), (200, 20.001), (300, 20.001)], 0.05),
    ("psnr_gate", [(100, 20.0), (200, 20.08), (300, 20.15)], 0.05),
    ("psnr_gate", [(100, 20.00), (200, 20.10), (300, 20.16), (400, 20.04)], 0.05),
    ("psnr_gate", [(100, 20.2), (200, 20.1), (300, 20.0)], 0.05),
    ("psnr_gate", [(100, 20.0)], 0.05),
    ("psnr_gate", [], 0.05),
    *[("psnr_gate", [(int(it), float(20 + np.random.RandomState(s).randn() * 0.1 + it * 1e-4))
                     for it in np.arange(1, 2 + s % 5) * 75], 0.02 * s) for s in range(6)],
    ("last_iter", '{"iter": 296, "l_g_pix": 0.1}\nnot json\n'
                  '{"iter": 300, "val_dataset": "validation", "psnr": 20.0}\n', None),
    ("last_iter", None, None),
    *[("last_iter", _metrics_text(np.random.RandomState(s)), None) for s in range(3)],
    *[("load_metrics_rows", _metrics_text(np.random.RandomState(10 + s)), None) for s in range(3)],
]


@pytest.mark.parametrize("fn,data,margin", GATE_CASES, ids=[f"{c[0]}-{i}" for i, c in
                                                            enumerate(GATE_CASES)])
def test_gates_equal_jax(fn, data, margin, tmp_path):
    if fn == "psnr_gate":
        got, want = tev._psnr_gate(data, margin), jax_tev._psnr_gate(data, margin)
    else:
        path = tmp_path / "metrics.jsonl"
        if data is not None:
            path.write_text(data)
        port_fn, jax_fn = ((tev._last_iter, jax_tev._last_iter) if fn == "last_iter"
                           else (tev.load_metrics_rows, jax_tev.load_metrics_rows))
        got, want = port_fn(str(path)), jax_fn(str(path))
    assert got == want
    if fn == "last_iter" and data and data.startswith('{"iter": 296'):
        assert got == 300


def _jax_section_keys():
    """The keys of the section dict the JAX `run_family` returns (its source)."""
    keys = set()
    for node in ast.walk(ast.parse(open(JAX_SCRIPT).read())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "section" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and getattr(node.targets[0].value, "id", None) == "section":
            keys.add(node.targets[0].slice.value)
    return keys


def _tiny(builder):
    def build(workdir, iters, val_freq, ckpt_freq, print_freq):
        opt = builder(workdir, iters, val_freq, ckpt_freq, print_freq)
        opt["datasets"]["train"]["batch_size_per_gpu"] = 2
        if opt["model_type"] == "SSRESRGANModel":
            opt["network_g"].update(num_feat=8, num_block=1, num_grow_ch=4)
            opt["network_d"]["num_feat"] = 8
            opt["train"]["perceptual_opt"]["layer_weights"] = {"conv1_2": 0.1}
        else:
            opt["network_g"]["hidden_channels"] = 16
        return opt
    return build


@pytest.mark.parametrize("family", ["esrgan", "l2"])
def test_tiny_run_preempts_and_resumes(family, tmp_path, monkeypatch):
    monkeypatch.setattr(tev, "EXPERIMENTS", str(tmp_path / "experiments"))
    monkeypatch.setattr(tev, "POLL_SECONDS", 0.05)
    monkeypatch.setitem(tev.FAMILIES, family, _tiny(tev.FAMILIES[family]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    work = tmp_path / "data"
    rng = np.random.RandomState(0)
    tev._make_split(str(work / "train"), 4, rng)
    tev._make_split(str(work / "val"), 2, rng)
    args = argparse.Namespace(iters=8, workdir=str(work), preempt_frac=0.4, psnr_margin=0.05,
                              device="cpu")
    section, ok = tev.run_family(family, args)
    assert section["resumed_ok"] is True, section
    want = _jax_section_keys() - ({"d_loss_bounds"} if family == "l2" else set())
    assert set(section) == want
    exp = tmp_path / "experiments" / f"evidence_{family}"
    logs = "".join(p.read_text() for p in exp.glob("train_*.log"))
    assert "Stop signal" in logs and "Resuming training from" in logs
    assert np.isfinite(section["loss_first"]) and np.isfinite(section["loss_last"])
    assert ok == section["pass"]

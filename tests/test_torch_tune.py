"""The port's train-step autotuner (satlas_sr_tpu_torch.tune) against the
JAX package's (satlas_sr_tpu.tune), on the CPU.

- `build_candidates` equals JAX's for the same arguments (auto remat,
  explicit lists, --effective_batch, non-RRDB generators, the dtype axis),
  `synth_batch` JAX's arrays and `recommend_force_yml` JAX's lines.
- A tiny CPU sweep (tests/test_tune.py's ESRGAN config, nf 8, one block)
  ranks accum x batch splits of one effective batch: every candidate ok,
  the JSON report with the JAX tuner's keys (read off a JAX run whose
  measurement is stubbed), the recommended overrides round-tripping through
  the port's option parser (`network_g:remat` created by --force_yml).
- A torch.OutOfMemoryError in one candidate is recorded as a failed row
  and the sweep goes on; any other error (a kernel that fails to build or
  launch) propagates out of the sweep.
"""

import json

import numpy as np
import pytest
import torch

import satlas_sr_tpu.tune as jax_tune
import satlas_sr_tpu_torch.models as port_models
from satlas_sr_tpu_torch import tune
from satlas_sr_tpu_torch.utils.options import parse_options
from test_tune import ESRGAN_YML, SRCNN_YML
from torch_threads import two_torch_threads  # noqa: F401

RRDB = {"network_g": {"type": "SSR_RRDBNet"}, "train": {}}
GRIDS = [
    (RRDB, [16, 32], None, None, None),
    (RRDB, [8, 16, 32], [False, "rdb"], 32, None),
    (RRDB, [8, 12, 16, 32], ["block", True, "conv_outs"], 32, None),
    ({"network_g": {"type": "SSR_RRDBNet", "remat": "rdb"}, "train": {"accum_steps": 4}},
     [16, 32, 64], None, None, None),
    ({"network_g": {"type": "SRCNN"}, "train": {"accum_steps": 2}}, [16, 32], None, None, None),
    (RRDB, [16], None, 32, ["float32", "bfloat16"]),
]


@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_candidates_and_recommendations_equal_jax(grid):
    opt, batches, remat, effective, dtypes = GRIDS[grid]
    got = tune.build_candidates(opt, batches, remat, effective, dtypes)
    assert got == jax_tune.build_candidates(opt, batches, remat, effective, dtypes)
    assert got
    for cand in got:
        assert tune.recommend_force_yml(cand) == jax_tune.recommend_force_yml(cand)


def test_synth_batch_equals_jax():
    opt = {"scale": 4, "model_type": "OSMObjESRGANModel",
           "datasets": {"train": {"n_s2_images": 3, "old_naip_path": "x"}}}
    got = tune.synth_batch(opt, 3, np.random.RandomState(0))
    want = jax_tune.synth_batch(opt, 3, np.random.RandomState(0))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def _run(module, tmp_path, yml, extra):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(yml)
    out = tmp_path / f"{module.__name__}.json"
    argv = ["-opt", str(cfg), "--iters", "1", "--trials", "1", "--out", str(out)] + extra
    rc = module.main(argv + (["--device", "cpu"] if module is tune else []))
    return rc, (json.loads(out.read_text()) if out.exists() else None)


def _jax_report_keys(tmp_path, monkeypatch):
    """The JAX tuner's report and row keys, its measurement stubbed out."""
    monkeypatch.setattr(jax_tune, "measure_candidate", lambda opt, cand, iters, trials: {
        **cand, "compile_s": 0.0, "ms_per_step": 1.0, "samples_per_s": 1.0, "ok": True})
    _, rep = _run(jax_tune, tmp_path, ESRGAN_YML, ["--batches", "2", "--remat", "false"])
    return set(rep), set(rep["candidates"][0])


def test_tiny_sweep_reports_jax_keys_and_round_trips(tmp_path, monkeypatch):
    rc, rep = _run(tune, tmp_path, ESRGAN_YML, ["--batches", "2,4", "--remat", "false,rdb",
                                                "--effective_batch", "4"])
    assert rc == 0
    report_keys, row_keys = _jax_report_keys(tmp_path, monkeypatch)
    assert set(rep) == report_keys
    assert rep["platform"] == "cpu" and rep["effective_batch"] == 4
    cands = rep["candidates"]
    assert [(c["batch"], c["remat"], c["accum"]) for c in cands] == [
        (2, False, 2), (2, "rdb", 2), (4, False, 1), (4, "rdb", 1)]
    for c in cands:
        assert row_keys <= set(c) and c["ok"] and c["samples_per_s"] > 0
        assert c["peak_memory_gb"] is None  # no card
    assert rep["best"] == max(cands, key=lambda c: c["samples_per_s"])
    opt, _ = parse_options(str(tmp_path), is_train=True,
                           argv=["-opt", str(tmp_path / "cfg.yml"), "--force_yml"]
                           + rep["recommended_force_yml"])
    assert opt["datasets"]["train"]["batch_size_per_gpu"] == rep["best"]["batch"]
    assert opt["train"]["accum_steps"] == rep["best"]["accum"]
    assert opt["network_g"]["remat"] == rep["best"]["remat"]


def test_l2_model_has_no_remat_axis(tmp_path):
    rc, rep = _run(tune, tmp_path, SRCNN_YML, ["--batches", "2"])
    assert rc == 0
    (cand,) = rep["candidates"]
    assert cand["ok"] and cand["remat"] is False and cand["accum"] == 1


def test_only_out_of_memory_becomes_a_row(tmp_path, monkeypatch):
    real = port_models.build_model

    def build(opt, device="cuda"):
        if opt["datasets"]["train"]["batch_size_per_gpu"] == 2:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(opt, device=device)

    monkeypatch.setattr(port_models, "build_model", build)
    rc, rep = _run(tune, tmp_path, ESRGAN_YML, ["--batches", "2,4", "--remat", "false"])
    assert rc == 0
    by_batch = {c["batch"]: c for c in rep["candidates"]}
    assert not by_batch[2]["ok"] and "out of memory" in by_batch[2]["error"]
    assert by_batch[4]["ok"] and rep["best"]["batch"] == 4

    def broken(opt, device="cuda"):
        raise RuntimeError("rdb kernel launch failed: invalid device function")

    monkeypatch.setattr(port_models, "build_model", broken)
    with pytest.raises(RuntimeError, match="rdb kernel launch failed"):
        _run(tune, tmp_path, ESRGAN_YML, ["--batches", "2,4", "--remat", "false"])

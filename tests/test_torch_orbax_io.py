"""The port's `train.checkpoint_backend: orbax` (utils/orbax_io.py: steps of
torch.distributed.checkpoint), mirroring tests/test_orbax_checkpoint.py:
backend selection, the save/resume round trip (weights, u/v, EMA and Adam
states bit-equal, and the next step too), the final save that skips a step
already written, discovery of committed steps only (an interrupted write's
`*.orbax-checkpoint-tmp-*` directory is ignored), `wait()` raising a failed
background write, and the train CLI: two iterations, --auto_resume to
three, bit-equal to a straight three-iteration run.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.api import CheckpointException

from satlas_sr_tpu_torch import ckpt
from satlas_sr_tpu_torch.models import build_model
from satlas_sr_tpu_torch.train import find_resume_state
from satlas_sr_tpu_torch.utils.orbax_io import OrbaxCheckpointIO, latest_committed_step
from test_torch_esrgan_train import small_opt
from test_torch_train_cli import make_tree, run, shipped
from torch_threads import two_torch_threads  # noqa: F401


def _opt(tmp_path):
    opt = small_opt(tmp_path)
    opt["train"]["checkpoint_backend"] = "orbax"
    return opt


def _batch(rng):
    return {"lr": (rng.rand(2, 32, 32, 6) * 255).astype(np.uint8),
            "hr": (rng.rand(2, 128, 128, 3) * 255).astype(np.uint8)}


def _tensors(model):
    """A snapshot of every tensor of the trainer's state."""
    out = {f"g.{k}": v for k, v in model.net_g.state_dict().items()}
    out.update({f"d.{k}": v for k, v in model.net_d.state_dict().items()})
    out.update({f"ema.{k}": v for k, v in model.net_g_ema.state_dict().items()})
    for net, opt in (("g", model.opt_g), ("d", model.opt_d)):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"opt_{net}.{i}.{k}": v for k, v in st.items()})
    return {k: v.clone() for k, v in out.items()}


def test_invalid_backend_rejected(tmp_path):
    opt = small_opt(tmp_path)
    opt["train"]["checkpoint_backend"] = "s3"
    with pytest.raises(ValueError, match="checkpoint_backend"):
        build_model(opt, device="cpu")


def test_save_resume_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    opt = _opt(tmp_path)
    model = build_model(copy.deepcopy(opt), device="cpu")
    batches = [_batch(rng) for _ in range(3)]
    model.train_iter(batches[0], 1)
    model.train_iter(batches[1], 2)
    model.save(epoch=0, current_iter=2)
    model.finish_checkpoints()
    root = tmp_path / "training_states" / "orbax"
    assert sorted(os.listdir(root)) == ["2"]
    assert sorted(os.listdir(root / "2")) == [".metadata", "__0_0.distcp"]
    assert (tmp_path / "models" / "net_g_2.pth").exists()  # the .pth mirror stays
    assert not list((tmp_path / "training_states").glob("*.state"))

    resumed = build_model(copy.deepcopy(opt), device="cpu")
    assert resumed.resume_training("orbax:2") == {"epoch": 0, "iter": 2}
    assert resumed.step == 2 and resumed.g_updates == resumed.d_updates == 2
    want, got = _tensors(model), _tensors(resumed)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert any(k.endswith("weight_u") for k in want)
    logs = {k: float(v) for k, v in model.train_iter(batches[2], 3).items()}
    assert {k: float(v) for k, v in resumed.train_iter(batches[2], 3).items()} == logs
    assert all(torch.equal(a, b) for a, b in zip(model.net_g.parameters(),
                                                 resumed.net_g.parameters()))

    # without a template the payload comes back whole from DCP's metadata
    step, payload = OrbaxCheckpointIO(str(root)).restore()
    assert step == 2 and sorted(payload) == ["epoch", "iter", "nets", "state"]
    assert torch.equal(payload["nets"]["g"]["params_ema"]["conv_first.weight"],
                       want["ema.conv_first.weight"])


def test_final_save_dedups_current_step(tmp_path):
    rng = np.random.RandomState(1)
    opt = _opt(tmp_path)
    model = build_model(opt, device="cpu")
    model.train_iter(_batch(rng), 1)
    model.save(epoch=0, current_iter=1)
    model.save(epoch=0, current_iter=-1)  # the end-of-training save at the same step
    model.finish_checkpoints()
    root = str(tmp_path / "training_states" / "orbax")
    assert latest_committed_step(root) == 1
    assert [n for n in os.listdir(root) if n.isdigit()] == ["1"]
    assert (tmp_path / "models" / "net_g_latest.pth").exists()


def test_discovery_sees_only_committed_steps(tmp_path):
    root = tmp_path / "training_states" / "orbax"
    for name in ("3", "7", "9.orbax-checkpoint-tmp-1234", "not_a_step"):
        os.makedirs(root / name)
    assert latest_committed_step(str(root)) == 7
    opt = {"auto_resume": True, "train": {"checkpoint_backend": "orbax"},
           "path": {"training_states": str(tmp_path / "training_states")}}
    assert find_resume_state(opt) == "orbax:7"
    opt["train"]["checkpoint_backend"] = "native"
    assert find_resume_state(opt) is None  # the native backend reads *.state only


def test_wait_raises_a_failed_background_write(tmp_path, monkeypatch, capsys):
    io = OrbaxCheckpointIO(str(tmp_path / "orbax"))

    def fail(self, plan, planner):
        raise OSError("disk full")

    monkeypatch.setattr(dcp.FileSystemWriter, "write_data", fail)
    io.save(5, {"w": torch.ones(3)})
    with pytest.raises(CheckpointException, match="disk full"):
        io.wait()
    assert latest_committed_step(io.root) is None
    assert [n for n in os.listdir(io.root) if ".orbax-checkpoint-tmp-" in n]
    io.save(6, {"w": torch.ones(3)})
    io._wait_at_exit()  # the atexit drain reports instead of raising
    assert "disk full" in capsys.readouterr().err
    io.close()


def test_train_cli_auto_resume_equals_a_straight_run(tmp_path):
    data = make_tree(tmp_path / "data", np.random.RandomState(0))
    exps = {}
    for name, plan in (("straight", [(3, ())]), ("resumed", [(2, ()), (3, ("--auto_resume",))])):
        for total, flags in plan:
            opt = shipped("esrgan_s2naip_urban.yml", tmp_path, data, total_iter=total)
            opt["name"] = name
            opt["train"]["checkpoint_backend"] = "orbax"
            exps[name] = run(tmp_path, opt, *flags)
    states = exps["resumed"] / "training_states"
    assert sorted(os.listdir(states / "orbax")) == ["2", "3"]
    assert not list(states.glob("*.state"))
    rows = [json.loads(line) for line in open(exps["resumed"] / "metrics.jsonl")]
    assert [r["iter"] for r in rows if "val_dataset" not in r] == [1, 2, 3]
    info = ckpt.inspect(str(states / "orbax"))
    assert info["status"] == "ok" and info["committed_steps"] == [2, 3] and info["step"] == 3
    assert set(info["collections"]) == {"nets", "state"}
    for name in ("net_g_latest.pth", "net_d_latest.pth"):
        a = torch.load(exps["straight"] / "models" / name, weights_only=True)
        b = torch.load(exps["resumed"] / "models" / name, weights_only=True)
        for key in a:
            assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), (name, key)

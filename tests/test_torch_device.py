"""The port's entry points default to CUDA and raise without a card; they
never fall back to the CPU on their own."""

import pytest
import torch

from satlas_sr_tpu_torch.archs import RRDBNet
from satlas_sr_tpu_torch.device import resolve_device
from satlas_sr_tpu_torch.inference import InferenceEngine
from satlas_sr_tpu_torch.infer import run_inference

TINY = dict(num_in_ch=6, num_out_ch=3, num_feat=8, num_block=1, num_grow_ch=4)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")


def test_resolve_device(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")


def test_default_device_entry_points_raise(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RRDBNet(**TINY)
    model = RRDBNet(device="cpu", **TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(model, batch_size=2)
    opt = {"data_dir": str(tmp_path), "save_path": str(tmp_path / "out"), "n_lr_images": 2,
           "scale": 4, "network_g": {"type": "SSR_RRDBNet", **TINY}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference(opt)
    assert not (tmp_path / "out").exists()


def test_new_entry_points_raise_without_a_card(no_cuda, tmp_path):
    from satlas_sr_tpu_torch.archs import SRCNN, HighResNet
    from satlas_sr_tpu_torch.infer_grid import run_grid

    cfg = dict(revisits=2, hidden_channels=16)
    for cls in (SRCNN, HighResNet):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(**cfg)
    opt = {"data_dir": str(tmp_path), "save_path": str(tmp_path / "out"), "n_lr_images": 2,
           "scale": 4, "network_g": {"type": "SSR_RRDBNet", **TINY}}
    for mode in ({}, {"whole_tile": True}, {"halo": 6}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_grid({**opt, **mode})
    assert not (tmp_path / "out").exists()

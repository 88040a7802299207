"""The port's checkpoint converter (satlas_sr_tpu_torch/convert_checkpoint.py)
against the JAX package's scripts/convert_checkpoint.py, on the CPU, for the
five arch types at small widths (seeded port weights, every tensor moved off
its init so no leaf is a constant):

- to_pth: from one JAX-written .msgpack, the port's .pth equals the JAX
  script's, collection for collection, key for key and bit for bit (the
  U-Net SN discriminator's weight_orig / weight_u / weight_v, the OSM
  discriminator's U-Net at the top level);
- from_pth: from one reference .pth, the JAX `load_pytree` reads the port's
  .msgpack to the tree the JAX script writes (keys, dtypes, bits), through
  param_key and num_block.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from satlas_sr_tpu.utils import checkpoint as jax_ckpt
from satlas_sr_tpu_torch import convert_checkpoint as cc
from satlas_sr_tpu_torch.archs import RRDBNet, SRCNN, HighResNet
from satlas_sr_tpu_torch.archs.discriminator import UNetDiscriminatorSN
from satlas_sr_tpu_torch.archs.osm_discriminator import OSMObjDiscriminator
from satlas_sr_tpu_torch.utils import torch_io
from torch_threads import two_torch_threads  # noqa: F401

_SPEC = importlib.util.spec_from_file_location(
    "jax_convert_checkpoint", os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                                           "convert_checkpoint.py"))
jax_cc = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_cc)

ARCHS = ("SSR_RRDBNet", "SSR_UNetDiscriminatorSN", "SRCNN", "HighResNet", "OSMObjDiscriminator")
L2 = dict(revisits=2, hidden_channels=16, output_size=32, device="cpu")


def _module(arch):
    return {"SSR_RRDBNet": lambda: RRDBNet(num_in_ch=6, num_out_ch=3, num_feat=8, num_block=2,
                                           num_grow_ch=4, seed=1, device="cpu"),
            "SSR_UNetDiscriminatorSN": lambda: UNetDiscriminatorSN(9, num_feat=8, seed=2,
                                                                   device="cpu"),
            "SRCNN": lambda: SRCNN(seed=3, **L2),
            "HighResNet": lambda: HighResNet(seed=4, **L2),
            "OSMObjDiscriminator": lambda: OSMObjDiscriminator(9, num_feat=16, seed=5,
                                                               device="cpu")}[arch]()


def _reference_state(arch, seed):
    """The arch's reference-format state dict, every tensor moved off its init."""
    gen = torch.Generator().manual_seed(seed)
    state = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
             for k, v in _module(arch).state_dict().items()}
    return torch_io.osm_disc_to_reference(state) if arch == "OSMObjDiscriminator" else state


_TO_JAX = {"SSR_RRDBNet": torch_io.rrdbnet_to_jax,
           "SSR_UNetDiscriminatorSN": torch_io.unet_disc_to_jax,
           "SRCNN": torch_io.srcnn_to_jax, "HighResNet": torch_io.highresnet_to_jax,
           "OSMObjDiscriminator": lambda s: torch_io.osm_disc_to_jax(
               torch_io.osm_disc_from_reference(s))}


def _jax_file_tree(arch):
    """What the JAX trainer writes: net_g with params and params_ema, a
    discriminator with params and its spectral u/v."""
    first = _TO_JAX[arch](_reference_state(arch, 10))
    if arch in ("SSR_UNetDiscriminatorSN", "OSMObjDiscriminator"):
        return first
    ema = _TO_JAX[arch](_reference_state(arch, 11))["params"]
    return {"params": first["params"], "params_ema": ema}


def _run_jax_script(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", *argv])
    jax_cc.main()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{prefix}/{key}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_to_pth_equals_the_jax_script(arch, tmp_path, monkeypatch):
    src = str(tmp_path / "in.msgpack")
    jax_ckpt.save_pytree(src, _jax_file_tree(arch))
    want_path, got_path = str(tmp_path / "jax.pth"), str(tmp_path / "port.pth")
    _run_jax_script(monkeypatch, "to_pth", src, want_path, arch)
    assert cc.main(["to_pth", src, got_path, arch, "--device", "cpu"]) == 0
    want = torch.load(want_path, weights_only=True)
    got = torch.load(got_path, weights_only=True)
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key])
        for name, tensor in want[key].items():
            same = got[key][name].dtype == tensor.dtype and torch.equal(got[key][name], tensor)
            assert same, name
    if arch == "SSR_UNetDiscriminatorSN":
        assert {"conv1.weight_orig", "conv1.weight_u", "conv1.weight_v"} <= set(got["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_from_pth_equals_the_jax_script(arch, tmp_path, monkeypatch):
    src = str(tmp_path / "in.pth")
    torch.save({"params": _reference_state(arch, 20), "params_ema": _reference_state(arch, 21)},
               src)
    key = "params" if arch in ("SSR_UNetDiscriminatorSN", "OSMObjDiscriminator") else "params_ema"
    extra = ["2"] if arch == "SSR_RRDBNet" else []
    want_path, got_path = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    _run_jax_script(monkeypatch, "from_pth", src, want_path, arch, key, *extra)
    assert cc.main(["from_pth", src, got_path, arch, key, *extra, "--device", "cpu"]) == 0
    want = dict(_leaves(jax_ckpt.load_pytree(want_path)))
    got = dict(_leaves(jax_ckpt.load_pytree(got_path)))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype and np.array_equal(got[name], value), name

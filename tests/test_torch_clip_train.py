"""Three steps of the port's ESRGAN trainer with `clip_opt` (the CLIPLoss term
of cliploss_esrgan_s2naip_urban.yml) against the JAX package's, on the CPU
in float32.

The small config of tests/test_torch_ssim_esrgan_train.py (G nf 8, one
block, g 4; U-Net SN D nf 4; VGG19 to conv1_2) with the shipped `clip_opt`,
its tower narrowed to `test-tiny-siglip` (the seeded random tower, equal on
both sides with no conversion). The JAX model starts from the port's
seeded G and D (`flax_init_from`). Held:
- every step's loss dict, l_clip_sim included, within 1e-4 relative;
- the first step's G and D gradients within 1e-4 of each tensor's max, D's
  last bias and a LeakyReLU kink of the D held by the rules of
  test_torch_step_bars.py (`assert_d_grads_match` of
  test_torch_ssim_esrgan_train.py);
- G, D (u/v) and the EMA after each step within 1e-5 absolute;
- the tower is frozen and stays out of G's optimizer, the EMA, the .pth and
  the .state: the saved net_g keys are the ESRGAN config's.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax

from satlas_sr_tpu.models import build_model as jax_build_model
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.models import build_model
from satlas_sr_tpu_torch.utils.checkpoint import load_state
from satlas_sr_tpu_torch.utils.torch_io import rrdbnet_from_jax, unet_disc_from_jax
from test_torch_osm_train import (first_step_evidence, flax_init_from,  # noqa: F401
                                  one_device_mesh)
from test_torch_ssim_esrgan_train import _jax_grads, assert_d_grads_match
from test_torch_ssim_esrgan_train import small_opt as ssim_small_opt
from torch_threads import two_torch_threads  # noqa: F401

STEPS = 3
CLIP_OPT = {"type": "CLIPLoss", "clip_loss_model": "test-tiny-siglip", "loss_weight": 1.0}


def small_opt(clip=True):
    opt = ssim_small_opt()
    opt["name"] = "clip_esrgan_small"
    del opt["train"]["ssim_opt"]
    if clip:
        opt["train"]["clip_opt"] = dict(CLIP_OPT)
    return opt


@pytest.fixture(scope="module")
def run():
    rng = np.random.RandomState(0)
    opt = small_opt()
    pm = build_model(copy.deepcopy(opt), device="cpu")
    numpy = lambda state: {k: v.numpy() for k, v in state.items()}
    with flax_init_from({
            "RRDBNet": jax_torch_io.rrdbnet_from_torch(numpy(pm.net_g.state_dict()), num_block=1),
            "UNetDiscriminatorSN": jax_torch_io.unet_disc_from_torch(numpy(pm.net_d.state_dict()))}):
        jm = jax_build_model(copy.deepcopy(opt))
    batch = {"lr": (rng.rand(2, 32, 32, 6) * 255).astype(np.uint8),
             "hr": (rng.rand(2, 128, 128, 3) * 255).astype(np.uint8)}
    first = jax.tree.map(np.array, jax.device_get(jm.state))  # the JAX steps donate theirs
    *jax_grads, jax_terms, jax_sides = _jax_grads(jm, first, batch)
    rec = {"jax_grads": jax_grads, "jax_terms": jax_terms, "jax_sides": jax_sides,
           "replay": lambda sides: _jax_grads(jm, first, batch, sides), "logs": [], "states": [],
           "model": pm}
    for it in range(1, STEPS + 1):
        want = {k: float(v) for k, v in jax.device_get(jm.train_iter(batch, it)).items()}
        with first_step_evidence(pm, batch) if it == 1 else contextlib.nullcontext({}) as found:
            got = {k: float(v) for k, v in pm.train_iter(batch, it).items()}
        rec.update(found)
        rec["logs"].append((got, want))
        if it == 1:
            rec["port_grads"] = ({n: p.grad.clone() for n, p in pm.net_g.named_parameters()},
                                 {n: p.grad.clone() for n, p in pm.net_d.named_parameters()})
        host = jax.device_get(jm.state)
        rec["states"].append(copy.deepcopy((
            {"g": pm.net_g.state_dict(), "d": pm.net_d.state_dict(),
             "ema": pm.net_g_ema.state_dict()},
            {"g": rrdbnet_from_jax({"params": host["g"]["params"]}),
             "d": unet_disc_from_jax(host["d"]), "ema": rrdbnet_from_jax({"params": host["ema"]})})))
    return rec


def test_loss_dicts_match_jax_every_step(run):
    for it, (got, want) in enumerate(run["logs"], 1):
        assert sorted(got) == sorted(want) == sorted(
            ["l_g_pix", "l_g_percep", "l_g_gan", "l_clip_sim", "l_d_real", "l_d_fake",
             "out_d_real", "out_d_fake"])
        assert got["l_clip_sim"] > 0
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (it, k, got[k], want[k])


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "discriminator"])
def test_first_step_gradients_match_jax(run, net):
    assert_d_grads_match(run, net, "clip-loss step")


@pytest.mark.parametrize("part", ["g", "d", "ema"])
def test_weights_spectral_and_ema_match_jax_after_each_step(run, part):
    for it, (got, want) in enumerate(run["states"], 1):
        for name, ref in want[part].items():
            err = (got[part][name] - ref).abs().max().item()
            assert err <= 1e-5, (it, part, name, err)


def test_the_tower_stays_out_of_the_generator(run, tmp_path):
    """The CLIP tower is frozen, outside G's optimizer and EMA, and no part of
    what is saved: net_g's .pth and the .state hold the keys an ESRGAN run
    without the CLIP loss saves."""
    pm = run["model"]
    from satlas_sr_tpu_torch.metrics.clip_encoder import get_encoder

    tower, _ = get_encoder("test-tiny-siglip", device="cpu")
    tower_ids = {id(p) for p in tower.parameters()}
    assert tower_ids and all(not p.requires_grad for p in tower.parameters())
    optimized = {id(p) for group in pm.opt_g.param_groups for p in group["params"]}
    assert optimized == {id(p) for p in pm.net_g.parameters()} and not optimized & tower_ids
    assert set(pm.net_g_ema.state_dict()) == set(pm.net_g.state_dict())

    plain = build_model(small_opt(clip=False), device="cpu")
    for model, tag in ((pm, "clip"), (plain, "plain")):
        model.opt["path"] = {"models": str(tmp_path / tag / "models"),
                             "training_states": str(tmp_path / tag / "training_states")}
        (tmp_path / tag / "training_states").mkdir(parents=True)
        model.save(0, 1)
    for net in ("g", "d"):
        got = torch.load(tmp_path / "clip" / "models" / f"net_{net}_1.pth", weights_only=True)
        want = torch.load(tmp_path / "plain" / "models" / f"net_{net}_1.pth", weights_only=True)
        assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in want.items()}
    states = [load_state(str(tmp_path / tag / "training_states" / "1.state"))["state"]
              for tag in ("clip", "plain")]
    assert sorted(states[0]) == sorted(states[1])
    assert sorted(states[0]["g"]["params"]) == sorted(states[1]["g"]["params"])
    groups = [[g["params"] for g in st["g"]["opt"]["param_groups"]] for st in states]
    assert groups[0] == groups[1]  # G's Adam holds G's parameters and nothing else
    assert set(states[0]["g"]["opt"]["state"]) == set(groups[0][0])

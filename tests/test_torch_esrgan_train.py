"""The port's ESRGAN GAN trainer (`ESRGANModel.train_iter`) against the JAX
package's on carried weights, on the CPU in float32.

One JAX model (on one JAX device: `one_device_mesh`) and one port model
are built from the same small config (nf 8, one block, g 4, D nf 4, VGG19
to conv1_2), the JAX generator, discriminator (with its spectral u/v) and
EMA carried over with `rrdbnet_from_jax` / `unet_disc_from_jax`; the VGG
tower is the shared numpy seed. Three steps run on the same batch, then a fourth with
net_d_init_iters raised so that the G update is gated off. Held:
- every step's loss dict within 1e-4 relative (zero logs exactly zero);
- the first step's G and D gradients within 1e-4 of each tensor's max
  (the JAX ones by jax.grad of the JAX step's own loss functions);
- spectral u/v, the EMA and the G and D parameters after each step within
  1e-5 absolute (Adam's first step moves a weight by about the lr, 1e-4).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.models import build_model as jax_build_model
from satlas_sr_tpu_torch.models import build_model
from satlas_sr_tpu_torch.utils.torch_io import rrdbnet_from_jax, unet_disc_from_jax
from test_torch_osm_train import one_device_mesh  # noqa: F401
from torch_threads import two_torch_threads  # noqa: F401

STEPS = 3


def small_opt(tmp_path):
    return {
        "name": "esrgan_small", "model_type": "SSRESRGANModel", "scale": 4, "manual_seed": 0,
        "is_train": True, "rank": 0, "world_size": 1, "compute_dtype": "float32",
        "l1_gt_usm": True, "percep_gt_usm": True, "gan_gt_usm": False, "feed_disc_lr": True,
        "datasets": {"train": {"name": "train", "type": "S2NAIPDataset", "n_s2_images": 2}},
        "network_g": {"type": "SSR_RRDBNet", "num_in_ch": 6, "num_out_ch": 3, "num_feat": 8,
                      "num_block": 1, "num_grow_ch": 4},
        "network_d": {"type": "SSR_UNetDiscriminatorSN", "num_in_ch": 9, "num_feat": 4},
        "path": {"models": str(tmp_path / "models"),
                 "training_states": str(tmp_path / "training_states")},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [2], "gamma": 0.5},
            "total_iter": 4, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "perceptual_opt": {"type": "PerceptualLoss", "layer_weights": {"conv1_2": 0.1},
                               "vgg_type": "vgg19", "use_input_norm": True,
                               "perceptual_weight": 1.0, "style_weight": 0, "range_norm": False,
                               "criterion": "l1"},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 0.1},
            "net_d_iters": 1, "net_d_init_iters": 0,
        },
        "val": None,
    }


def _host(jm):
    return jax.device_get(jm.state)


def _port_g(variables):
    return rrdbnet_from_jax({"params": variables})


def _jax_first_grads(jm, state, batch):
    """jax.grad of the JAX step's G and D loss functions at `state`."""

    def grads(state, lr_u8, hr_u8):
        lr, old_hr, l1_gt, percep_gt, gan_gt, lr_resized = jm._prep_step_inputs(lr_u8, hr_u8, None)
        d_params, spectral = state["d"]["params"], state["d"]["spectral"]
        g_grads, (_, out, spec1) = jax.grad(
            lambda p: jm._g_loss_and_aux(p, lr, l1_gt, percep_gt, lr_resized, old_hr,
                                         d_params, spectral), has_aux=True)(state["g"]["params"])
        real_in = jm._disc_input(gan_gt, lr_resized, old_hr)
        fake_in = jm._disc_input(jax.lax.stop_gradient(out), lr_resized, old_hr)
        d_grads, _ = jax.grad(lambda p: jm._d_loss_and_aux(p, real_in, fake_in, spec1),
                              has_aux=True)(d_params)
        return g_grads, d_grads

    g, d = jax.jit(grads)(state, jnp.asarray(batch["lr"]), jnp.asarray(batch["hr"]))
    return _port_g(jax.device_get(g)), unet_disc_from_jax({"params": jax.device_get(d)})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("esrgan_train")
    rng = np.random.RandomState(0)
    opt = small_opt(tmp_path)
    jm = jax_build_model(copy.deepcopy(opt))
    pm = build_model(copy.deepcopy(opt), device="cpu")
    host = _host(jm)
    pm.net_g.load_state_dict(_port_g(host["g"]["params"]))
    pm.net_d.load_state_dict(unet_disc_from_jax(host["d"]))
    pm.net_g_ema.load_state_dict(_port_g(host["ema"]))
    batch = {"lr": (rng.rand(2, 32, 32, 6) * 255).astype(np.uint8),
             "hr": (rng.rand(2, 128, 128, 3) * 255).astype(np.uint8)}
    rec = {"jax_grads": _jax_first_grads(jm, host, batch), "logs": [], "states": []}
    for it in range(1, STEPS + 2):
        if it == STEPS + 1:  # gate the G update off: net_d_init_iters past this step
            jm.net_d_init_iters = pm.net_d_init_iters = 10
            jm._train_step = jm._build_train_step()
        want = {k: float(v) for k, v in jax.device_get(jm.train_iter(batch, it)).items()}
        got = {k: float(v) for k, v in pm.train_iter(batch, it).items()}
        rec["logs"].append((got, want))
        if it == 1:
            rec["port_grads"] = (
                {n: p.grad.clone() for n, p in pm.net_g.named_parameters()},
                {n: p.grad.clone() for n, p in pm.net_d.named_parameters()})
        host = _host(jm)
        rec["states"].append(({"g": pm.net_g.state_dict(), "d": pm.net_d.state_dict(),
                               "ema": pm.net_g_ema.state_dict()},
                              {"g": _port_g(host["g"]["params"]), "d": unet_disc_from_jax(host["d"]),
                               "ema": _port_g(host["ema"])}))
        rec["states"][-1] = copy.deepcopy(rec["states"][-1])
    return rec


def test_loss_dicts_match_jax_every_step(run):
    for it, (got, want) in enumerate(run["logs"], 1):
        assert sorted(got) == sorted(want) == sorted(
            ["l_g_pix", "l_g_percep", "l_g_gan", "l_d_real", "l_d_fake", "out_d_real", "out_d_fake"])
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (it, k, got[k], want[k])


def test_gated_step_logs_zero_generator_losses(run):
    got, want = run["logs"][STEPS]
    for k in ("l_g_pix", "l_g_percep", "l_g_gan"):
        assert got[k] == want[k] == 0.0
    assert got["l_d_real"] > 0 and got["l_d_fake"] > 0
    before, after = run["states"][STEPS - 1][0], run["states"][STEPS][0]
    assert all(torch.equal(before["g"][n], after["g"][n]) for n in before["g"])  # G frozen
    assert not all(torch.equal(before["d"][n], after["d"][n]) for n in before["d"])  # D trains
    assert not all(torch.equal(before["ema"][n], after["ema"][n]) for n in before["ema"])


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "discriminator"])
def test_first_step_gradients_match_jax(run, net):
    got, want = run["port_grads"][net], run["jax_grads"][net]
    assert set(want) <= set(got)
    for name, ref in want.items():
        err = (got[name] - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item() + 1e-12, (name, err, ref.abs().max().item())


@pytest.mark.parametrize("part", ["g", "d", "ema"])
def test_weights_spectral_and_ema_match_jax_after_each_step(run, part):
    for it, (got, want) in enumerate(run["states"], 1):
        for name, ref in want[part].items():
            err = (got[part][name] - ref).abs().max().item()
            assert err <= 1e-5, (it, part, name, err)
        if part == "d":
            assert any(n.endswith("weight_u") for n in want["d"])

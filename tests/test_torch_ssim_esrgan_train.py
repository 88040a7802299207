"""One step of the port's ESRGAN trainer with `ssim_opt` (the SSIMLoss term of
ssimloss_esrgan_s2naip_urban.yml) against the JAX package's, on the CPU in
float32.

The small config of tests/test_torch_esrgan_train.py (G nf 8, one block,
g 4; U-Net SN D nf 4; VGG19 to conv1_2) plus `ssim_opt: {type: SSIMLoss,
loss_weight: 1.0}`. The JAX model starts from the port's seeded G and D
(`flax_init_from`, shared with test_torch_osm_train.py). Held, as there:
the loss dict (l_g_ssim included) within 1e-4 relative; the G and D gradients within 1e-4 of each tensor's max (the
JAX ones by jax.grad of the JAX step's own loss functions), D's last bias
(one cancelling sum over the logits) and the D weights upstream of a
LeakyReLU input within float32 rounding of zero (one conv2 output on the
other side of the kink in the port's step than in JAX's) by the rules of
test_torch_step_bars.py (`assert_d_grads_match`); spectral
u/v, the EMA and the weights after the step within 1e-5 absolute.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.models import build_model as jax_build_model
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.models import build_model
from satlas_sr_tpu_torch.utils.torch_io import rrdbnet_from_jax, unet_disc_from_jax
from test_torch_osm_train import (d_kinks, first_step_evidence, flax_init_from,  # noqa: F401
                                  one_device_mesh)
from test_torch_step_bars import CancellingSum, grads_close, jax_logit_terms, jax_lrelu_sides
from torch_threads import two_torch_threads  # noqa: F401


def small_opt():
    return {
        "name": "ssim_esrgan_small", "model_type": "SSRESRGANModel", "scale": 4,
        "manual_seed": 0, "is_train": True, "rank": 0, "world_size": 1,
        "compute_dtype": "float32", "l1_gt_usm": True, "percep_gt_usm": True,
        "gan_gt_usm": False, "feed_disc_lr": True,
        "datasets": {"train": {"name": "train", "type": "S2NAIPDataset", "n_s2_images": 2}},
        "network_g": {"type": "SSR_RRDBNet", "num_in_ch": 6, "num_out_ch": 3, "num_feat": 8,
                      "num_block": 1, "num_grow_ch": 4},
        "network_d": {"type": "SSR_UNetDiscriminatorSN", "num_in_ch": 9, "num_feat": 4},
        "path": {},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [2], "gamma": 0.5},
            "total_iter": 1, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "perceptual_opt": {"type": "PerceptualLoss", "layer_weights": {"conv1_2": 0.1},
                               "vgg_type": "vgg19", "use_input_norm": True,
                               "perceptual_weight": 1.0, "style_weight": 0, "range_norm": False,
                               "criterion": "l1"},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 0.1},
            "ssim_opt": {"type": "SSIMLoss", "loss_weight": 1.0},
            "net_d_iters": 1, "net_d_init_iters": 0,
        },
        "val": None,
    }


def _jax_grads(jm, state, batch, sides=None):
    """jax.grad of the JAX step's G and D losses at `state`: G and D
    gradients in the port's names, the cotangents of D's per-pixel logits
    and the inputs of the D update's LeakyReLUs; with `sides` (the port's
    D update LeakyReLU sides) the D gradients alone, each of those
    LeakyReLUs on the port's side."""
    def grads(state, lr_u8, hr_u8):
        lr, old_hr, l1_gt, percep_gt, gan_gt, lr_resized = jm._prep_step_inputs(lr_u8, hr_u8, None)
        d_params, spectral = state["d"]["params"], state["d"]["spectral"]
        g_grads, (_, out, spec1) = jax.grad(
            lambda p: jm._g_loss_and_aux(p, lr, l1_gt, percep_gt, lr_resized, old_hr,
                                         d_params, spectral), has_aux=True)(state["g"]["params"])
        real_in = jm._disc_input(gan_gt, lr_resized, old_hr)
        fake_in = jm._disc_input(jax.lax.stop_gradient(out), lr_resized, old_hr)

        def d_loss(p):
            with jax_lrelu_sides(sides) as xs:
                loss, _ = jm._d_loss_and_aux(p, real_in, fake_in, spec1)
            return loss, xs

        d_grads, xs = jax.grad(d_loss, has_aux=True)(d_params)
        if sides is not None:
            return d_grads
        # the logits of _d_loss_and_aux's two forwards, for their cotangents
        real, mut = jm.net_d.apply({"params": d_params, "spectral": spec1}, real_in,
                                   update_stats=True, mutable=["spectral"])
        fake, _ = jm.net_d.apply({"params": d_params, "spectral": mut["spectral"]}, fake_in,
                                 update_stats=True, mutable=["spectral"])
        return g_grads, d_grads, jax_logit_terms(jm.cri_gan, real, fake), xs

    found = jax.device_get(jax.jit(grads)(state, jnp.asarray(batch["lr"]), jnp.asarray(batch["hr"])))
    if sides is not None:
        return unet_disc_from_jax({"params": found})
    g, d, terms, xs = found
    return (rrdbnet_from_jax({"params": g}), unet_disc_from_jax({"params": d}),
            torch.from_numpy(np.array(terms)), [torch.from_numpy(np.array(x)) for x in xs])


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
    host = jax.device_get(jm.state)
    batch = {"lr": (rng.rand(2, 32, 32, 6) * 255).astype(np.uint8),
             "hr": (rng.rand(2, 128, 128, 3) * 255).astype(np.uint8)}
    *jax_grads, jax_terms, jax_sides = _jax_grads(jm, host, batch)
    first = jax.tree.map(np.array, host)  # a copy: the JAX step below donates its buffers
    rec = {"jax_grads": jax_grads, "jax_terms": jax_terms, "jax_sides": jax_sides,
           "replay": lambda sides: _jax_grads(jm, first, batch, sides)}
    rec["want"] = {k: float(v) for k, v in jax.device_get(jm.train_iter(batch, 1)).items()}
    with first_step_evidence(pm, batch) as found:
        rec["got"] = {k: float(v) for k, v in pm.train_iter(batch, 1).items()}
    rec.update(found)
    rec["port_grads"] = ({n: p.grad.clone() for n, p in pm.net_g.named_parameters()},
                         {n: p.grad.clone() for n, p in pm.net_d.named_parameters()})
    host = jax.device_get(jm.state)
    rec["states"] = ({"g": pm.net_g.state_dict(), "d": pm.net_d.state_dict(),
                      "ema": pm.net_g_ema.state_dict()},
                     {"g": rrdbnet_from_jax({"params": host["g"]["params"]}),
                      "d": unet_disc_from_jax(host["d"]), "ema": rrdbnet_from_jax({"params": host["ema"]})})
    return rec


def test_loss_dict_matches_jax(run):
    got, want = run["got"], run["want"]
    assert sorted(got) == sorted(want) == sorted(
        ["l_g_pix", "l_g_percep", "l_g_ssim", "l_g_gan", "l_d_real", "l_d_fake", "out_d_real",
         "out_d_fake"])
    assert 0 < got["l_g_ssim"] < 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "discriminator"])
def test_gradients_match_jax(run, net):
    assert_d_grads_match(run, net, "ssim-loss step")


def assert_d_grads_match(run, net, what):
    """The U-Net D trainers' first-step gradients against JAX's, by the
    rules of test_torch_step_bars.py: D's last bias by its cancelling sum,
    a LeakyReLU kink against JAX's gradients on the port's sides."""
    got, want, exact = (run[k][net] for k in ("port_grads", "jax_grads", "f64_grads"))
    sums = kinks = None
    if net == 1:
        sums = {"conv9.bias": CancellingSum(run["port_terms"], run["jax_terms"],
                                            exact["conv9.bias"].item())}
        kinks = d_kinks(run)
    grads_close(got, want, 1e-4, (what, net), sums=sums, kinks=kinks)


@pytest.mark.parametrize("part", ["g", "d", "ema"])
def test_weights_spectral_and_ema_match_jax_after_the_step(run, part):
    got, want = run["states"]
    assert set(got[part]) >= set(want[part])
    for name, ref in want[part].items():
        err = (got[part][name] - ref).abs().max().item()
        assert err <= 1e-5, (part, name, err)

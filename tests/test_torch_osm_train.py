"""The port's OSM-object GAN trainer (`OSMObjESRGANModel.train_iter`) against
the JAX package's, on the CPU in float32.

One JAX model and one port model from the same small config (G nf 8, one
block, g 4; OSMObjDiscriminator with a U-Net of nf 4; VGG19 to conv1_2;
two objects an image) and an osm_chips_to_masks.json whose chips have
several boxes (one degenerate), one box, or none. The JAX model starts from
the port's seeded G and D (attention gammas set non-zero), carried into
flax by the JAX package's reference-.pth importers; its G, D (with the
spectral u/v) and EMA come back through `rrdbnet_from_jax` /
`osm_disc_from_jax`. Three steps on one batch. Held:
- the sampled boxes equal to the JAX trainer's, every step;
- every step's loss dict within 1e-4 relative;
- the first step's G and D gradients within 1e-4 of each tensor's max, the
  object branch's included (the JAX ones by jax.grad of the same loss
  functions as the JAX step, written out below from its parts). A bias
  whose gradient is one sum of cancelling terms over the 3 x 128 x 128
  pixels (D's last conv: its max is ~1e-3 of the terms' sum) differs by
  the float32 rounding of that sum, on either side (here the port's reads
  7.7e-4 of its max from its float64 step, JAX's 5.8e-5); such a bias is
  held instead, both sides, within 1e-3 of the port's float64 step
  (`port_float64_grads`), as in test_torch_l2_train.py;
- spectral u/v, the EMA and the G and D parameters after each step within
  1e-5 absolute.
Then one port step gated off (net_d_init_iters past it) logs zeros for every
G loss, l_g_gan_objs too.
"""

import contextlib
import copy
import json

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from satlas_sr_tpu.models import build_model as jax_build_model
from satlas_sr_tpu.ops.crop import crop_resize_boxes as jax_crop
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.models import build_model
from satlas_sr_tpu_torch.utils.torch_io import (osm_disc_from_jax, osm_disc_to_reference,
                                                rrdbnet_from_jax)
from torch_threads import two_torch_threads  # noqa: F401

STEPS = 3
OSM = {"700_800": {"building": [[10, 20, 40, 60], [5, 7, 5, 30]], "road": [[90, 100, 128, 128]]},
       "701_801": {"building": [[0, 0, 17, 9]]},
       "702_802": {}}


@pytest.fixture(scope="module", autouse=True)
def one_device_mesh():
    """The JAX trainers on a one-device mesh (the test files that import this
    fixture get it too): a batch of 2 or 3 rows is only replicated over the
    conftest's eight CPU devices, so on those the step runs eight times;
    the numbers are those of one device."""
    from unittest import mock

    from jax.sharding import Mesh

    import satlas_sr_tpu.models.base as jax_base

    with mock.patch.object(jax_base, "data_mesh",
                           lambda: Mesh(np.array(jax.devices()[:1]), ("data",))):
        yield


@contextlib.contextmanager
def flax_init_from(variables):
    """While active, flax's Module.init of a class named in `variables`
    returns those variables instead of initialising (eager flax init of the
    G and the OSM D takes most of a minute here): the JAX trainer starts
    from the port's seeded weights, as from pretrained ones."""
    eager = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        given = variables.get(type(self).__name__)
        if given is None:
            return eager(self, rngs, *args, **kwargs)
        return jax.tree.map(jnp.asarray, given)

    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = eager


def small_opt(osm_path):
    return {
        "name": "osm_small", "model_type": "OSMObjESRGANModel", "scale": 4, "manual_seed": 0,
        "is_train": True, "rank": 0, "world_size": 1, "compute_dtype": "float32",
        "l1_gt_usm": True, "percep_gt_usm": True, "gan_gt_usm": False, "feed_disc_lr": True,
        "osm_obj_weight": 0.3, "n_osm_objs": 2,
        "datasets": {"train": {"name": "train", "type": "S2NAIPDataset", "n_s2_images": 2,
                               "osm_objs_path": osm_path, "n_osm_objs": 2}},
        "network_g": {"type": "SSR_RRDBNet", "num_in_ch": 6, "num_out_ch": 3, "num_feat": 8,
                      "num_block": 1, "num_grow_ch": 4},
        "network_d": {"type": "OSMObjDiscriminator", "num_in_ch": 9, "num_feat": 4},
        "path": {},
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


def port_float64_grads(pm, batch):
    """The first step's G and D gradients of a copy of `pm` whose networks
    run in float64 (the VGG tower and the GAN loss keep their float32 parts;
    the gradient sums run in float64)."""
    m = copy.deepcopy(pm)
    m.net_g.double()
    m.net_d.double()
    m.net_g_ema, m.dtype = None, torch.float64
    m.train_iter(batch, 1)
    return ({n: p.grad for n, p in m.net_g.named_parameters()},
            {n: p.grad for n, p in m.net_d.named_parameters()})


def _port_d(host_d):
    return osm_disc_from_jax({"params": host_d["params"], "spectral": host_d["spectral"]})


def _jax_first_grads(jm, state, batch, boxes):
    """jax.grad of the JAX OSM step's G and D losses at `state` (its
    g_update.loss_fn and d_loss_fn, from the model's own parts)."""
    net_g, net_d, gan, w = jm.net_g, jm.net_d, jm.cri_gan, jm.osm_obj_weight
    objs = lambda img: jax_crop(img, boxes).reshape(-1, 32, 32, 3)

    def grads(state, lr_u8, hr_u8):
        lr, old_hr, l1_gt, percep_gt, gan_gt, lr_resized = jm._prep_step_inputs(lr_u8, hr_u8, None)
        d_params, spectral = state["d"]["params"], state["d"]["spectral"]

        def g_loss(p):
            out = net_g.apply({"params": p}, lr)
            total, _ = jm._g_content_losses(out, l1_gt, percep_gt)
            (fake_pred, obj_pred), mut = net_d.apply(
                {"params": d_params, "spectral": spectral}, jm._disc_input(out, lr_resized, old_hr),
                objs(out), update_stats=True, mutable=["spectral"])
            total += gan(fake_pred, True, is_disc=False) + w * gan(obj_pred, True, is_disc=False)
            return total, (out, mut["spectral"])

        g_grads, (out, spec1) = jax.grad(g_loss, has_aux=True)(state["g"]["params"])
        fake = jax.lax.stop_gradient(out)

        def d_loss(p):
            (real_pred, real_obj), mut = net_d.apply(
                {"params": p, "spectral": spec1}, jm._disc_input(gan_gt, lr_resized, old_hr),
                objs(gan_gt), update_stats=True, mutable=["spectral"])
            (fake_pred, fake_obj), _ = net_d.apply(
                {"params": p, "spectral": mut["spectral"]}, jm._disc_input(fake, lr_resized, old_hr),
                objs(fake), update_stats=True, mutable=["spectral"])
            return (gan(real_pred, True, is_disc=True) + w * gan(real_obj, True, is_disc=True)
                    + gan(fake_pred, False, is_disc=True) + w * gan(fake_obj, True, is_disc=True))

        return g_grads, jax.grad(d_loss)(d_params)

    g, d = jax.jit(grads)(state, jnp.asarray(batch["lr"]), jnp.asarray(batch["hr"]))
    return (rrdbnet_from_jax({"params": jax.device_get(g)}),
            osm_disc_from_jax({"params": jax.device_get(d)}))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("osm_train")
    osm_path = str(tmp_path / "osm_chips_to_masks.json")
    with open(osm_path, "w") as f:
        json.dump(OSM, f)
    rng = np.random.RandomState(0)
    opt = small_opt(osm_path)
    pm = build_model(copy.deepcopy(opt), device="cpu")
    with torch.no_grad():
        pm.net_d.o_attention1.gamma.fill_(0.5)
        pm.net_d.o_attention2.gamma.fill_(-0.3)
    numpy = lambda state: {k: v.numpy() for k, v in state.items()}
    with flax_init_from({
            "RRDBNet": jax_torch_io.rrdbnet_from_torch(numpy(pm.net_g.state_dict()), num_block=1),
            "OSMObjDiscriminator": jax_torch_io.osm_disc_from_torch(
                numpy(osm_disc_to_reference(pm.net_d.state_dict())))}):
        jm = jax_build_model(copy.deepcopy(opt))
    host = jax.device_get(jm.state)
    pm.net_g.load_state_dict(rrdbnet_from_jax({"params": host["g"]["params"]}))
    pm.net_d.load_state_dict(_port_d(host["d"]))
    pm.net_g_ema.load_state_dict(rrdbnet_from_jax({"params": host["ema"]}))
    batch = {"lr": (rng.rand(3, 32, 32, 6) * 255).astype(np.uint8),
             "hr": (rng.rand(3, 128, 128, 3) * 255).astype(np.uint8),
             "Chip": sorted(OSM)}
    first_boxes = jm._sample_boxes(batch["Chip"], np.random.RandomState(1 % (2 ** 31 - 1)))
    rec = {"jax_grads": _jax_first_grads(jm, host, batch, jnp.asarray(first_boxes)),
           "f64_grads": port_float64_grads(pm, batch), "logs": [], "states": [], "boxes": []}
    for it in range(1, STEPS + 1):
        want = {k: float(v) for k, v in jax.device_get(jm.train_iter(batch, it)).items()}
        got = {k: float(v) for k, v in pm.train_iter(batch, it).items()}
        seed_rng = np.random.RandomState((0 * 7919 + it) % (2 ** 31 - 1))
        rec["boxes"].append((pm.boxes.copy(), jm._sample_boxes(batch["Chip"], seed_rng)))
        rec["logs"].append((got, want))
        if it == 1:
            rec["port_grads"] = (
                {n: p.grad.clone() for n, p in pm.net_g.named_parameters()},
                {n: p.grad.clone() for n, p in pm.net_d.named_parameters()})
        host = jax.device_get(jm.state)
        rec["states"].append(copy.deepcopy((
            {"g": pm.net_g.state_dict(), "d": pm.net_d.state_dict(),
             "ema": pm.net_g_ema.state_dict()},
            {"g": rrdbnet_from_jax({"params": host["g"]["params"]}), "d": _port_d(host["d"]),
             "ema": rrdbnet_from_jax({"params": host["ema"]})})))
    pm.net_d_init_iters = 10  # gate the G update off
    rec["gated"] = {k: float(v) for k, v in pm.train_iter(batch, STEPS + 1).items()}
    return rec


def test_boxes_equal_the_jax_trainers(run):
    for it, (got, want) in enumerate(run["boxes"], 1):
        assert got.dtype == want.dtype == np.int32 and got.shape == (3, 2, 4)
        assert np.array_equal(got, want), it
    boxes = np.concatenate([b for b, _ in run["boxes"]])
    assert (boxes[..., 2] > boxes[..., 0]).all() and (boxes[..., 3] > boxes[..., 1]).all()
    assert [0, 0, 128, 128] in boxes[:, 0].tolist() or [0, 0, 128, 128] in boxes[:, 1].tolist()


def test_loss_dicts_match_jax_every_step(run):
    for it, (got, want) in enumerate(run["logs"], 1):
        assert sorted(got) == sorted(want) == sorted(
            ["l_g_pix", "l_g_percep", "l_g_gan", "l_g_gan_objs", "l_d_real", "l_d_fake",
             "l_d_real_objs", "l_d_fake_objs", "out_d_real", "out_d_fake"])
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (it, k, got[k], want[k])


def test_gated_step_logs_zero_generator_losses(run):
    for k in ("l_g_pix", "l_g_percep", "l_g_gan", "l_g_gan_objs"):
        assert run["gated"][k] == 0.0
    assert run["gated"]["l_d_real_objs"] > 0


def assert_grads_match(got, want, exact):
    """Each gradient within 1e-4 of its JAX reference's max; where not, a bias
    (one cancelling sum) with the port's and JAX's both within 1e-3 of the
    float64 reference `exact`."""
    assert set(want) <= set(got)
    off_jax = []
    for name, ref in want.items():
        scale = ref.abs().max().item() + 1e-12
        err = (got[name] - ref).abs().max().item()
        if err <= 1e-4 * scale:
            continue
        off_jax.append(name)
        port_err = (got[name].double() - exact[name]).abs().max().item()
        jax_err = (ref.double() - exact[name]).abs().max().item()
        assert err <= 1e-3 * scale and max(port_err, jax_err) <= 1e-3 * scale, (
            name, err / scale, port_err / scale, jax_err / scale)
    assert all(n.endswith("bias") for n in off_jax), off_jax


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "discriminator"])
def test_first_step_gradients_match_jax(run, net):
    got, want, exact = (run[k][net] for k in ("port_grads", "jax_grads", "f64_grads"))
    if net == 1:
        assert any(n.startswith("o_attention2.") for n in want)
    assert_grads_match(got, want, exact)


@pytest.mark.parametrize("part", ["g", "d", "ema"])
def test_weights_spectral_and_ema_match_jax_after_each_step(run, part):
    for it, (got, want) in enumerate(run["states"], 1):
        assert set(got[part]) == set(want[part])
        for name, ref in want[part].items():
            err = (got[part][name] - ref).abs().max().item()
            assert err <= 1e-5, (it, part, name, err)

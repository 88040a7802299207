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
  functions as the JAX step, written out below from its parts). The D's
  last bias is one sum of the cotangents of the 2 x 3 x 128 x 128 logits,
  which cancel (sum |t| ~1e3 |sum t|), and torch's CPU reduction rounds it
  more than JAX's (the port 1.46e-3 of itself from its float64 step
  (`port_float64_grads`), JAX 1.27e-4): it is held by the cancelling-sum
  rule of test_torch_step_bars.py, on the logits' cotangents recorded in
  the first step on both sides; the attention key biases, whose gradient
  softmax makes zero (~1e-10 here), by the same rule on the keys'
  cotangents (a sum that cancels completely); the U-Net's conv2 weight by
  its kink rule (one conv2 output within float32 rounding of zero lies on
  the other side of the LeakyReLU in the port's step than in JAX's: held
  at the same bar against JAX's gradients with the port's sides,
  `first_step_evidence`, `d_kinks`);
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
from satlas_sr_tpu_torch.archs import osm_discriminator as port_osm_d
from test_torch_step_bars import (CancellingSum, KinkSides, grads_close, jax_logit_terms,
                                  jax_lrelu_sides, jax_output_cotangents, logit_terms,
                                  logit_terms_of, lrelu_sides)
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


@contextlib.contextmanager
def key_cotangents_of(net_d):
    """While active, the cotangent of each output of an OSM D attention
    block's key conv, in call order: [(block name, cotangent NHWC)]."""
    keys = {id(m.key_conv): f"{n}.key_conv.bias" for n, m in net_d.named_modules()
            if hasattr(m, "key_conv")}
    rec, orig = [], port_osm_d._nhwc_conv

    def conv(c, x):
        y = orig(c, x)
        if id(c) in keys and y.requires_grad:
            slot = [keys[id(c)], None]
            y.register_hook(lambda g: slot.__setitem__(1, g.detach().clone()))
            rec.append(slot)
        return y

    port_osm_d._nhwc_conv = conv
    try:
        yield rec
    finally:
        port_osm_d._nhwc_conv = orig


@contextlib.contextmanager
def first_step_evidence(pm, batch):
    """Around the port's first `train_iter(batch, 1)` (run in the block):
    the float64 step before it, and from the float32 step the cotangents of
    D's logits, the inputs of its U-Net's LeakyReLUs and, for the OSM D,
    the cotangents of its attention keys. Yields a dict, filled on exit:
    f64_grads (G, D), port_terms, port_sides (every LeakyReLU call of the
    step, the G update's D forward first), port_keys ({block: [N, C]} of
    the D update)."""
    out = {"f64_grads": port_float64_grads(pm, batch)}
    keys = key_cotangents_of(pm.net_d) if hasattr(pm.net_d, "o_attention1") else \
        contextlib.nullcontext([])
    with logit_terms_of(pm) as terms, lrelu_sides() as sides, keys as key_rec:
        yield out
    out["port_terms"], out["port_sides"] = logit_terms(terms), sides
    d_step = key_rec[-4:]  # the D update: real then fake, attention1 then attention2 each
    out["port_keys"] = {name: torch.cat([t.reshape(-1, t.shape[-1]) for n, t in d_step
                                         if n == name])
                        for name in dict.fromkeys(n for n, _ in d_step)}


def _port_d(host_d):
    return osm_disc_from_jax({"params": host_d["params"], "spectral": host_d["spectral"]})


def _jax_first_grads(jm, state, batch, boxes, sides=None):
    """jax.grad of the JAX OSM step's G and D losses at `state` (its
    g_update.loss_fn and d_loss_fn, from the model's own parts): G and D
    gradients in the port's names, the cotangents of D's per-pixel logits,
    the inputs of the D update's LeakyReLUs and the cotangents of its
    attention keys ({block: [N, C]}); with `sides` (the port's D update
    LeakyReLU sides) the D gradients alone, each of those LeakyReLUs on
    the port's side."""
    net_g, net_d, gan, w = jm.net_g, jm.net_d, jm.cri_gan, jm.osm_obj_weight
    objs = lambda img: jax_crop(img, boxes).reshape(-1, 32, 32, 3)
    keys = lambda m: isinstance(m, nn.Conv) and m.name == "key"

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
            with jax_lrelu_sides(sides) as xs:
                (real_pred, real_obj), mut = net_d.apply(
                    {"params": p, "spectral": spec1}, jm._disc_input(gan_gt, lr_resized, old_hr),
                    objs(gan_gt), update_stats=True, mutable=["spectral"])
                (fake_pred, fake_obj), _ = net_d.apply(
                    {"params": p, "spectral": mut["spectral"]},
                    jm._disc_input(fake, lr_resized, old_hr), objs(fake), update_stats=True,
                    mutable=["spectral"])
            return (gan(real_pred, True, is_disc=True) + w * gan(real_obj, True, is_disc=True)
                    + gan(fake_pred, False, is_disc=True) + w * gan(fake_obj, True, is_disc=True),
                    (real_pred, fake_pred, xs))

        with jax_output_cotangents(keys) as key_taps:
            d_grads, (*logits, xs) = jax.grad(d_loss, has_aux=True)(d_params)
        taps.append(key_taps)
        if sides is not None:
            return d_grads
        return g_grads, d_grads, jax_logit_terms(gan, *logits), xs

    taps = []
    found = jax.device_get(jax.jit(grads)(state, jnp.asarray(batch["lr"]), jnp.asarray(batch["hr"])))
    if sides is not None:
        return osm_disc_from_jax({"params": found})
    g, d, terms, xs = found
    jax.effects_barrier()
    key_taps = taps[0]  # real then fake, attention1 then attention2 each
    keys = {f"o_attention{b}.key_conv.bias": torch.cat(
        [key_taps[i].reshape(-1, key_taps[i].shape[-1]) for i in (b - 1, b + 1)])
        for b in (1, 2)}
    return (rrdbnet_from_jax({"params": g}), osm_disc_from_jax({"params": d}),
            torch.from_numpy(np.array(terms)), [torch.from_numpy(np.array(x)) for x in xs], keys)


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
    *jax_grads, jax_terms, jax_sides, jax_keys = _jax_first_grads(jm, host, batch,
                                                                  jnp.asarray(first_boxes))
    first = jax.tree.map(np.array, host)  # a copy: the JAX steps below donate their buffers
    rec = {"jax_grads": jax_grads, "jax_terms": jax_terms, "jax_sides": jax_sides,
           "jax_keys": jax_keys, "logs": [], "states": [], "boxes": [],
           "replay": lambda sides: _jax_first_grads(jm, first, batch, jnp.asarray(first_boxes),
                                                    sides)}
    for it in range(1, STEPS + 1):
        want = {k: float(v) for k, v in jax.device_get(jm.train_iter(batch, it)).items()}
        with first_step_evidence(pm, batch) if it == 1 else contextlib.nullcontext({}) as found:
            got = {k: float(v) for k, v in pm.train_iter(batch, it).items()}
        rec.update(found)
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


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "discriminator"])
def test_first_step_gradients_match_jax(run, net):
    got, want, exact = (run[k][net] for k in ("port_grads", "jax_grads", "f64_grads"))
    sums = kinks = None
    if net == 1:
        assert any(n.startswith("o_attention2.") for n in want)
        bias = "unet.conv9.bias"  # one sum of every per-pixel logit's cotangent
        sums = {bias: CancellingSum(run["port_terms"], run["jax_terms"], exact[bias].item())}
        for name, terms in run["jax_keys"].items():  # sums over the keys: zero
            sums[name] = CancellingSum(run["port_keys"][name], terms, exact[name])
        kinks = d_kinks(run)
    grads_close(got, want, 1e-4, ("osm first step", net), sums=sums, kinks=kinks)


def d_kinks(run):
    """The D update's LeakyReLU inputs on both sides, and JAX's D gradients
    recomputed on the port's sides (test_torch_step_bars.KinkSides)."""
    port = run["port_sides"][-len(run["jax_sides"]):]  # after the G update's D forward
    return KinkSides(port, run["jax_sides"],
                     lambda: run["replay"]([np.asarray(x.numpy() > 0) for x in port]))


@pytest.mark.parametrize("part", ["g", "d", "ema"])
def test_weights_spectral_and_ema_match_jax_after_each_step(run, part):
    for it, (got, want) in enumerate(run["states"], 1):
        assert set(got[part]) == set(want[part])
        for name, ref in want[part].items():
            err = (got[part][name] - ref).abs().max().item()
            assert err <= 1e-5, (it, part, name, err)

"""Gradient accumulation (`train.accum_steps`), remat and the JAX `.state`
resume in the port's three trainer families, against the JAX package on the
CPU in float32.

Each family builds one JAX and one port model from the same small config
(G nf 8, one block, g 4; D nf 4; VGG19 to conv1_2; SRCNN hidden 16) with
accum_steps 2, the JAX model starting from the port's seeded weights
(`flax_init_from`), and runs two `train_iter`s on k x b = 2 x 2 rows of
seeded numpy data. Held, every step:
- the loss dict within 1e-4 relative;
- G and D parameters, the spectral u/v and the EMA within 1e-4 of each
  tensor's max (+ 1e-6, see `_close`; the JAX ones through the port's
  `*_from_jax`), an element whose JAX gradient was at its tensor's noise
  floor held by test_torch_step_bars.py's rule (JAX's gradient at each
  step from its Adam first moments, `adam_grads`).
L2 dropout masks: while the JAX L2 step is traced its lax.scan over the
micro-batches runs as a Python loop (`python_scan`: the same ops, each
micro-batch traced on its own), so test_torch_l2_train's RecordedDropout
hands out every mask in the order the step draws it, and the port replays
them (`DropoutMasks.replay`).
Then each JAX trainer saves its `.state` and nets at step 2;
a fresh port model resumes from the .state (params, Adam moments and
counts, u/v, EMA, step) and its step 3 is held to the JAX step 3 as above;
the JAX net_g .msgpack loads through the port's `load_network_variables`
equal to the JAX EMA.
Port-only: accum 2 x 2 against one native batch-4 step with the GAN weight
at 0 (rtol 1e-4, atol 2e-5, the JAX test's bar); remat block / rdb /
conv_outs bit-equal to no remat; a batch accum_steps does not divide raises
the JAX package's ValueError.
"""

import copy
import json
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.models import build_model as jax_build_model
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.models import build_model
from satlas_sr_tpu_torch.utils.checkpoint import load_network_variables
from satlas_sr_tpu_torch.utils.torch_io import (osm_disc_from_jax, osm_disc_to_reference,
                                                rrdbnet_from_jax, srcnn_from_jax,
                                                unet_disc_from_jax)
from test_torch_esrgan_train import small_opt as esrgan_opt
from test_torch_l2_train import RecordedDropout, small_opt as l2_opt
from test_torch_osm_train import OSM, flax_init_from, small_opt as osm_opt
from test_torch_step_bars import adam_grads, optax_mu, weights_close
from torch_threads import two_torch_threads  # noqa: F401

K, B = 2, 2
LR, B1 = 1e-4, 0.9  # the small configs' optim_g and optim_d: lr (the largest) and betas[0]


@pytest.fixture(scope="module", autouse=True)
def one_device_mesh():
    """The JAX models on a one-device mesh: the 2-row micro-batches would
    only be replicated over the conftest's eight CPU devices, and compiling
    for eight costs this file's time, not its numbers."""
    from jax.sharding import Mesh

    import satlas_sr_tpu.models.base as jax_base

    with mock.patch.object(jax_base, "data_mesh",
                           lambda: Mesh(np.array(jax.devices()[:1]), ("data",))):
        yield


def _numpy(state):
    return {k: v.numpy() for k, v in state.items()}


def _batch(rng, lr_shape):
    return {"lr": (rng.rand(K * B, *lr_shape) * 255).astype(np.uint8),
            "hr": (rng.rand(K * B, 128, 128, 3) * 255).astype(np.uint8)}


def _floats(logs):
    return {k: float(v) for k, v in jax.device_get(logs).items()}


def _close(got, want, what, grads=None):
    """Each tensor within 1e-4 of its max, plus 1e-6 absolute (1% of Adam's
    per-step move at lr 1e-4): a parameter whose gradient is zero up to
    rounding (an attention key's bias: softmax ignores it) moves by Adam's
    lr x g / (|g| + eps), 1e-8 to 1e-7 a step, on either side. An element
    whose JAX gradient (`grads`: {name: [its gradient at each step]}) was at
    its tensor's noise floor at a step may leave that bar, by the noise-floor
    rule of test_torch_step_bars.py (within 2 lr a step: six elements of
    the OSM D's unet.conv3-5.weight_orig; the attention key biases, whose
    gradient is zero at the network's resolution, by its zero branch)."""
    assert set(want) <= set(got), (what, sorted(set(want) - set(got)))
    weights_close(got, want, lambda ref: 1e-4 * ref.abs().max() + 1e-6, what, grads, LR)


def _jax_grads(mus, parts=("g", "d")):
    """{part: {name: [JAX's gradient at each step]}} from the Adam first
    moments after each step (`mus`, in order)."""
    return {part: adam_grads([m[part] for m in mus], B1) for part in parts}


def python_scan(f, init, xs, length=None, reverse=False, unroll=1):
    """jax.lax.scan as a Python loop over the leading axis (no reverse):
    the body is traced once per iteration, so jax.random.bernoulli is called
    once per micro-batch and mask at trace time, in the order the step runs
    them (RecordedDropout numbers its masks by that order)."""
    assert not reverse
    carry, ys = init, []
    for i in range(jax.tree.leaves(xs)[0].shape[0]):
        carry, y = f(carry, jax.tree.map(lambda x: x[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def _gan_states(pm, jm, disc_from_jax):
    host = jax.device_get(jm.state)
    return ({"g": pm.net_g.state_dict(), "d": pm.net_d.state_dict(),
             "ema": pm.net_g_ema.state_dict()},
            {"g": rrdbnet_from_jax({"params": host["g"]["params"]}),
             "d": disc_from_jax(host["d"]), "ema": rrdbnet_from_jax({"params": host["ema"]})})


def _jax_mu(jm, disc_from_jax):
    """The JAX trainer's Adam first moments, in the port's names."""
    host = jax.device_get(jm.state)
    return {"g": rrdbnet_from_jax({"params": optax_mu(host["g"]["opt"])}),
            "d": disc_from_jax({"params": optax_mu(host["d"]["opt"])})}


def _run_gan(pm, jm, batches, disc_from_jax, first_iter=1):
    """Per step: ((port logs, JAX logs), (port states, JAX states), JAX's
    Adam first moments after the step)."""
    rec = []
    for it, batch in enumerate(batches, first_iter):
        want = _floats(jm.train_iter(batch, it))
        got = _floats(pm.train_iter(batch, it))
        rec.append(((got, want), copy.deepcopy(_gan_states(pm, jm, disc_from_jax)),
                    _jax_mu(jm, disc_from_jax)))
    return rec


@pytest.fixture(scope="module")
def esrgan(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("accum_esrgan")
    rng = np.random.RandomState(0)
    opt = esrgan_opt(tmp)
    opt["train"]["accum_steps"] = K
    pm = build_model(copy.deepcopy(opt), device="cpu")
    with flax_init_from({
            "RRDBNet": jax_torch_io.rrdbnet_from_torch(_numpy(pm.net_g.state_dict()), num_block=1),
            "UNetDiscriminatorSN": jax_torch_io.unet_disc_from_torch(
                _numpy(pm.net_d.state_dict()))}):
        jm = jax_build_model(copy.deepcopy(opt))
    batches = [_batch(rng, (32, 32, 6)) for _ in range(3)]
    rec = {"steps": _run_gan(pm, jm, batches[:2], unet_disc_from_jax)}
    jm.save(0, 2)
    rec["msgpack"] = (load_network_variables("SSR_RRDBNet", str(tmp / "models" / "net_g_2.msgpack"),
                                             None, "params_ema"),
                      rrdbnet_from_jax({"params": jax.device_get(jm.state)["ema"]}))
    resumed = build_model(copy.deepcopy(opt), device="cpu")
    rec["info"] = resumed.resume_training(str(tmp / "training_states" / "2.state"))
    rec["resumed_step"] = resumed.step
    rec["step3"] = _run_gan(resumed, jm, [batches[2]], unet_disc_from_jax, 3)[0]
    return rec


@pytest.fixture(scope="module")
def osm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("accum_osm")
    osm_path = str(tmp / "osm_chips_to_masks.json")
    with open(osm_path, "w") as f:
        json.dump(OSM, f)
    rng = np.random.RandomState(1)
    opt = osm_opt(osm_path)
    opt["train"]["accum_steps"] = K
    pm = build_model(copy.deepcopy(opt), device="cpu")
    with torch.no_grad():
        pm.net_d.o_attention1.gamma.fill_(0.5)
        pm.net_d.o_attention2.gamma.fill_(-0.3)
    with flax_init_from({
            "RRDBNet": jax_torch_io.rrdbnet_from_torch(_numpy(pm.net_g.state_dict()), num_block=1),
            "OSMObjDiscriminator": jax_torch_io.osm_disc_from_torch(
                _numpy(osm_disc_to_reference(pm.net_d.state_dict())))}):
        jm = jax_build_model(copy.deepcopy(opt))
    opt["path"] = {"models": str(tmp / "models"), "training_states": str(tmp / "training_states")}
    batches = []
    for _ in range(3):
        batch = _batch(rng, (32, 32, 6))
        batch["Chip"] = sorted(OSM) + ["703_803"]
        batches.append(batch)
    rec = {"steps": _run_gan(pm, jm, batches[:2], osm_disc_from_jax)}
    jm.opt["path"] = opt["path"]
    jm.save(0, 2)
    resumed = build_model(copy.deepcopy(opt), device="cpu")
    rec["info"] = resumed.resume_training(str(tmp / "training_states" / "2.state"))
    rec["step3"] = _run_gan(resumed, jm, [batches[2]], osm_disc_from_jax, 3)[0]
    return rec


def _l2_states(pm, jm):
    host = jax.device_get(jm.state)
    return ({"g": pm.net_g.state_dict(), "ema": dict(pm.ema)},
            {"g": srcnn_from_jax({"params": host["params"]}),
             "ema": srcnn_from_jax({"params": host["ema"]})})


def _run_l2(pm, jm, batches, dropout, first_iter=1):
    rec = []
    for it, batch in enumerate(batches, first_iter):
        dropout.masks.clear()
        want = _floats(jm.train_iter(batch, it))
        jax.effects_barrier()
        pm.dropout_masks.replay(dropout.in_order())
        got = _floats(pm.train_iter(batch, it))
        rec.append(((got, want), copy.deepcopy(_l2_states(pm, jm)),
                    (len(dropout.masks), len(pm.dropout_masks.queue))))
    return rec


@pytest.fixture(scope="module")
def l2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("accum_l2")
    rng = np.random.RandomState(2)
    opt = l2_opt("SRCNN")
    opt["train"]["accum_steps"] = K
    opt["path"] = {"models": str(tmp / "models"), "training_states": str(tmp / "training_states")}
    pm = build_model(copy.deepcopy(opt), device="cpu")
    with flax_init_from({"SRCNN": jax_torch_io.srcnn_from_torch(_numpy(pm.net_g.state_dict()),
                                                                residual_layers=1)}):
        jm = jax_build_model(copy.deepcopy(opt))
    host = jax.device_get(jm.state)
    pm.net_g.load_state_dict(srcnn_from_jax({"params": host["params"]}))
    batches = [_batch(rng, (4, 32, 32, 3)) for _ in range(3)]
    # the step's callbacks go to the recorder it was traced under: one for all
    with RecordedDropout() as dropout, mock.patch.object(jax.lax, "scan", python_scan):
        rec = {"steps": _run_l2(pm, jm, batches[:2], dropout)}
        jm.save(0, 2)
        resumed = build_model(copy.deepcopy(opt), device="cpu")
        rec["info"] = resumed.resume_training(str(tmp / "training_states" / "2.state"))
        rec["step3"] = _run_l2(resumed, jm, [batches[2]], dropout, first_iter=3)[0]
    return rec


FAMILIES = ["esrgan", "osm", "l2"]


@pytest.mark.parametrize("family", FAMILIES)
def test_accumulated_losses_match_jax(family, request):
    rec = request.getfixturevalue(family)
    for it, ((got, want), *_) in enumerate(rec["steps"], 1):
        assert sorted(got) == sorted(want), (it, sorted(got), sorted(want))
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 1e-7, (it, k, got[k], want[k])


@pytest.mark.parametrize("family", FAMILIES)
def test_accumulated_params_spectral_and_ema_match_jax(family, request):
    rec = request.getfixturevalue(family)
    for it, (_, (got, want), *_) in enumerate(rec["steps"], 1):
        grads = _jax_grads([mu for *_, mu in rec["steps"][:it]]) if family != "l2" else {}
        for part in want:
            _close(got[part], want[part], (family, it, part), grads.get(part))
    if family != "l2":
        assert any(n.endswith("weight_u") for n in rec["steps"][0][1][1]["d"])


def test_l2_masks_of_every_micro_batch_replayed(l2):
    for *_, (drawn, left) in l2["steps"] + [l2["step3"]]:
        assert drawn == K * 6 and left == 0  # 3 DoubleConv2d a forward, 2 dropouts each


@pytest.mark.parametrize("family", FAMILIES)
def test_resume_from_jax_state_then_step3_matches_jax(family, request):
    rec = request.getfixturevalue(family)
    assert rec["info"] == {"epoch": 0, "iter": 2}
    (got, want), (got_s, want_s), *_ = rec["step3"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 1e-7, (k, got[k], want[k])
    grads = {}
    if family != "l2":  # the port resumed JAX's step-2 state: step 3 is the one step taken
        grads = {part: {n: g[-1:] for n, g in by_name.items()}
                 for part, by_name in _jax_grads([rec["steps"][-1][-1], rec["step3"][-1]]).items()}
    for part in want_s:
        _close(got_s[part], want_s[part], (family, 3, part), grads.get(part))


def test_jax_msgpack_weights_load_in_the_port(esrgan):
    got, want = esrgan["msgpack"]
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert esrgan["resumed_step"] == 2


# -- port only ------------------------------------------------------------------


def _port_step(opt, batch, **train):
    o = copy.deepcopy(opt)
    o["train"].update(train)
    model = build_model(o, device="cpu")
    return model, {k: float(v) for k, v in model.train_iter(batch, 1).items()}


@pytest.fixture(scope="module")
def port_opt(tmp_path_factory):
    opt = esrgan_opt(tmp_path_factory.mktemp("accum_port"))
    opt["train"]["gan_opt"]["loss_weight"] = 0.0
    rng = np.random.RandomState(3)
    return opt, _batch(rng, (32, 32, 6))


def test_accum_step_equals_native_batch_step(port_opt):
    opt, batch = port_opt
    native, ln = _port_step(opt, batch)
    accum, la = _port_step(opt, batch, accum_steps=K)
    assert abs(ln["l_g_pix"] - la["l_g_pix"]) < 1e-5
    for net in ("net_g", "net_g_ema"):
        for a, b in zip(getattr(native, net).parameters(), getattr(accum, net).parameters()):
            torch.testing.assert_close(b, a, rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module")
def no_remat(port_opt):
    """The step without remat, once for every mode held to it."""
    return _port_step(*port_opt)


@pytest.mark.parametrize("mode", [True, "block", "rdb", "conv_outs"])
def test_remat_is_bit_equal_to_no_remat(port_opt, no_remat, mode):
    opt, batch = port_opt
    ref, ref_logs = no_remat
    o = copy.deepcopy(opt)
    o["network_g"]["remat"] = mode
    model, logs = _port_step(o, batch)
    assert logs == ref_logs
    for (name, a), b in zip(ref.net_g.named_parameters(), model.net_g.parameters()):
        assert torch.equal(a.grad, b.grad), name
        assert torch.equal(a, b), name


def test_unknown_remat_mode_raises(port_opt):
    opt, _ = port_opt
    o = copy.deepcopy(opt)
    o["network_g"]["remat"] = "everything"
    with pytest.raises(ValueError, match="remat must be"):
        build_model(o, device="cpu")


def test_batch_not_divisible_by_accum_steps_raises(port_opt):
    opt, batch = port_opt
    o = copy.deepcopy(opt)
    o["train"]["accum_steps"] = 3
    model = build_model(o, device="cpu")
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        model.train_iter(batch, 1)

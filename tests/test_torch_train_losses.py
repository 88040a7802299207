"""The trainer's losses, schedule, optimizers, EMA, samplers and train loader
in the port against the JAX package's, on the CPU in float32.

Tolerances: losses and VGG19 features within 1e-5 relative (float32 convs in
another summation order); the lr schedule within 1e-6 relative (JAX computes
it in float32, the port in float64); parameters after Adam/AdamW/SGD steps
within 1e-6 relative to each tensor's max (the same update in another
rounding order); the EMA within 1e-7; the samplers' index streams and the
loaders' batches exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from satlas_sr_tpu.data import build_dataset as jax_build_dataset
from satlas_sr_tpu.data.loader import build_train_loader as jax_train_loader
from satlas_sr_tpu.data import sampler as jax_sampler
from satlas_sr_tpu.losses import basic as jax_basic
from satlas_sr_tpu.losses import perceptual as jax_perceptual
from satlas_sr_tpu.losses import vgg as jax_vgg
from satlas_sr_tpu.models import base as jax_base
from satlas_sr_tpu.utils.imgio import write_png
from satlas_sr_tpu_torch.data import build_dataset, build_train_loader
from satlas_sr_tpu_torch.data import sampler
from satlas_sr_tpu_torch.losses import basic, build_loss, perceptual, vgg
from satlas_sr_tpu_torch.models import base
from torch_threads import two_torch_threads  # noqa: F401


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "hinge", "wgan"])
@pytest.mark.parametrize("target_is_real,is_disc", [(True, True), (False, True), (True, False)])
def test_gan_loss_matches_jax(rng, gan_type, target_is_real, is_disc):
    logits = (3 * rng.randn(2, 16, 16, 1)).astype(np.float32)
    kw = dict(gan_type=gan_type, real_label_val=1.0, fake_label_val=0.0, loss_weight=0.1)
    got = basic.gan_loss(**kw)(torch.from_numpy(logits), target_is_real, is_disc)
    want = jax_basic.gan_loss(**kw)(jnp.asarray(logits), target_is_real, is_disc)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("loss_type", ["L1Loss", "MSELoss"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_pixel_losses_match_jax(rng, loss_type, reduction):
    a, b = rng.rand(2, 8, 8, 3).astype(np.float32), rng.rand(2, 8, 8, 3).astype(np.float32)
    opt = {"type": loss_type, "loss_weight": 0.7, "reduction": reduction}
    got = build_loss(opt)(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_basic.build_loss(opt)(jnp.asarray(a), jnp.asarray(b))
    assert _rel(got, want) <= 1e-6


def test_vgg19_seeded_tower_is_the_jax_one():
    got, want = vgg.init_vgg19_params(3), jax_vgg.init_vgg19_params(3)
    assert list(got) == list(want)
    for name in want:
        for key in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][key], want[name][key])


def test_vgg19_features_match_jax(rng):
    params = vgg.init_vgg19_params(0)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    taps = ["conv1_2", "conv2_2", "conv3_4"]
    got = vgg.vgg19_features(vgg.torch_params(params), torch.from_numpy(x), taps)
    want = jax_vgg.vgg19_features(jax.tree.map(jnp.asarray, params), jnp.asarray(x), taps)
    assert sorted(got) == sorted(want) == sorted(taps)
    for k in taps:
        assert _rel(got[k].permute(0, 2, 3, 1).numpy(), want[k]) <= 1e-5, k


def test_vgg19_loads_torchvision_weights(tmp_path, rng):
    conv_names = [item[0] for item in vgg.VGG19_PLAN if item != "M"]
    state, cin = {}, 3
    for name, idx in zip(conv_names, vgg._TORCHVISION_CONV_IDX):
        cout = dict(i for i in vgg.VGG19_PLAN if i != "M")[name]
        state[f"features.{idx}.weight"] = torch.from_numpy(rng.randn(cout, cin, 3, 3).astype(np.float32))
        state[f"features.{idx}.bias"] = torch.from_numpy(rng.randn(cout).astype(np.float32))
        cin = cout
    path = str(tmp_path / "vgg19.pth")
    torch.save(state, path)
    got, want = vgg.load_vgg19_from_torch(path), jax_vgg.load_vgg19_from_torch(path)
    for name in want:
        np.testing.assert_array_equal(got[name]["kernel"], want[name]["kernel"])
        np.testing.assert_array_equal(got[name]["bias"], want[name]["bias"])
    assert vgg.get_vgg19_params(path)[1] is True


@pytest.mark.parametrize("style_weight", [0.0, 0.5])
def test_perceptual_loss_matches_jax(rng, style_weight):
    pred, gt = rng.rand(2, 32, 32, 3).astype(np.float32), rng.rand(2, 32, 32, 3).astype(np.float32)
    kw = dict(layer_weights={"conv1_2": 0.1, "conv2_2": 1.0}, perceptual_weight=1.0,
              style_weight=style_weight, criterion="l1")
    p = torch.from_numpy(pred).requires_grad_()
    got_p, got_s = perceptual.perceptual_loss(**kw)(p, torch.from_numpy(gt))
    want_fn = jax_perceptual.perceptual_loss(**kw)
    want_p, want_s = want_fn(jnp.asarray(pred), jnp.asarray(gt))
    assert _rel(got_p.detach(), want_p) <= 1e-5
    if style_weight:
        assert _rel(got_s.detach(), want_s) <= 1e-5
    else:
        assert got_s is None and want_s is None
    got_p.backward()
    want_g = jax.grad(lambda a: want_fn(a, jnp.asarray(gt))[0])(jnp.asarray(pred))
    assert _rel(p.grad, want_g) <= 1e-4


SCHEDULES = [
    dict(milestones=[3, 6], gamma=0.5),
    dict(milestones=[3, 6, 9], gamma=0.1, warmup_iter=4),
    dict(milestones=[2, 5, 8, 11], gamma=0.5, restarts=[6], restart_weights=[0.5]),
    dict(milestones=[], gamma=0.5, restarts=[0, 4, 8], restart_weights=[1.0, 0.3, 0.1]),
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=range(len(SCHEDULES)))
def test_multistep_lr_matches_jax(sched):
    got = base.multistep_lr(2e-4, **sched)
    want = jax_base.multistep_lr(2e-4, **sched)
    for step in range(14):
        assert abs(got(step) - float(want(step))) <= 1e-6 * 2e-4, (step, got(step), want(step))


@pytest.mark.parametrize("optim_opt", [
    {"type": "Adam", "lr": 1e-2, "weight_decay": 0.05, "betas": [0.9, 0.99]},
    {"type": "Adam", "lr": 1e-2, "weight_decay": 0, "betas": [0.9, 0.99]},
    {"type": "AdamW", "lr": 1e-2, "weight_decay": 0.05, "betas": [0.8, 0.95]},
    {"type": "SGD", "lr": 1e-2, "momentum": 0.9},
], ids=["adam_l2", "adam", "adamw", "sgd_momentum"])
def test_optimizer_steps_match_jax(rng, optim_opt):
    """Three updates on the same gradients, the lr set from the schedule
    before each (milestone at 2)."""
    shapes = [(4, 3, 3, 3), (7,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(3)]
    sched = dict(milestones=[2], gamma=0.5)
    tx = jax_base.build_optimizer(optim_opt, jax_base.multistep_lr(optim_opt["lr"], **sched))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = base.build_optimizer(optim_opt, tp)
    schedule = base.multistep_lr(optim_opt["lr"], **sched)
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        base.set_lr(opt, schedule(step))
        opt.step()
        for got, want in zip(tp, jp):
            assert _rel(got.detach(), want) <= 1e-6, (step, _rel(got.detach(), want))


def test_ema_update_matches_jax(rng):
    ema = [rng.randn(5, 3).astype(np.float32), rng.randn(4).astype(np.float32)]
    params = [rng.randn(5, 3).astype(np.float32), rng.randn(4).astype(np.float32)]
    want = jax_base.ema_update([jnp.asarray(e) for e in ema], [jnp.asarray(p) for p in params], 0.999)
    got = [torch.from_numpy(e.copy()) for e in ema]
    base.ema_update(got, [torch.from_numpy(p) for p in params], 0.999)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)


@pytest.mark.parametrize("start", [0, 7, 400])
def test_weighted_sampler_matches_jax(rng, start):
    w = rng.rand(23) + 0.01
    got = sampler.WeightedInfiniteSampler(w, seed=5, chunk=300).iter_from(start)
    want = jax_sampler.WeightedInfiniteSampler(w, seed=5, chunk=300).iter_from(start)
    assert [next(got) for _ in range(700)] == [next(want) for _ in range(700)]


@pytest.mark.parametrize("shuffle", [True, False])
def test_enlarged_sampler_matches_jax_and_fast_forwards(shuffle):
    got = sampler.EnlargedShuffleSampler(11, seed=3, ratio=2, shuffle=shuffle)
    want = jax_sampler.EnlargedShuffleSampler(11, seed=3, ratio=2, shuffle=shuffle)
    full = [next(it) for it in [iter(got)] for _ in range(100)]
    assert full == [next(it) for it in [iter(want)] for _ in range(100)]
    ff = got.iter_from(37)
    assert [next(ff) for _ in range(63)] == full[37:]


def _tree(root, rng, chips=5, frames=3):
    for c in range(chips):
        chip = f"{500 + c}_{600 + c}"
        write_png(str(root / "naip" / chip / f"{chip}.png"),
                  (rng.rand(128, 128, 3) * 254 + 1).astype(np.uint8))
        write_png(str(root / "sentinel2" / chip / "tci.png"),
                  (rng.rand(frames * 32, 32, 3) * 254 + 1).astype(np.uint8))
    return {"name": "train", "type": "S2NAIPDataset", "phase": "train", "scale": 4,
            "sentinel2_path": str(root / "sentinel2"), "naip_path": str(root / "naip"),
            "n_s2_images": 2, "use_shuffle": True, "batch_size_per_gpu": 2,
            "num_worker_per_gpu": 2}


@pytest.mark.parametrize("weighted", [False, True])
def test_train_loader_matches_jax_and_resumes(tmp_path, rng, weighted):
    """The same batch stream as the JAX loader for one seed, and a loader
    started at sample 3 batches in gives exactly the batches from there.
    The JAX loader feeds batch_size_per_gpu x its local devices, the port
    batch_size_per_gpu (one card): the port is given the JAX loader's rows."""
    opt = _tree(tmp_path, rng)
    if weighted:
        chips = sorted(os.listdir(tmp_path / "naip"))
        with open(tmp_path / "w.json", "w") as f:
            json.dump({chips[0]: 20.0, chips[2]: 0.5}, f)
        opt["tile_weights"] = str(tmp_path / "w.json")
    jl = jax_train_loader(jax_build_dataset(opt), opt, seed=7)
    rows = int(opt["batch_size_per_gpu"]) * jax.local_device_count()
    popt = {**opt, "batch_size_per_gpu": rows}
    pl = build_train_loader(build_dataset(popt), popt, seed=7)
    try:
        want = [b for _, b in zip(range(5), jl)]
        got = [b for _, b in zip(range(5), pl)]
    finally:
        jl.stop()
        pl.stop()
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in ("lr", "hr"):
            np.testing.assert_array_equal(a[key], b[key])
    resumed = build_train_loader(build_dataset(popt), popt, seed=7, start_sample=3 * rows)
    try:
        tail = [b for _, b in zip(range(2), resumed)]
    finally:
        resumed.stop()
    for a, b in zip(tail, got[3:]):
        np.testing.assert_array_equal(a["lr"], b["lr"])
        np.testing.assert_array_equal(a["hr"], b["hr"])

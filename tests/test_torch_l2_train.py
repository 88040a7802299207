"""The port's L2 trainer (`L2Model.train_iter`: SRCNN / HighResNet with the
WorldStrat loss) against the JAX package's, on the CPU in float32.

One JAX model and one port model per arch are built from the same small
config (hidden 16, the least the x4 PixelShuffle head takes; 4 revisits;
EMA on). The JAX model starts from the port's seeded weights (flax's init
returns them: `flax_init_from`, shared with test_torch_osm_train.py); its
weights and EMA come back through `srcnn_from_jax` / `highresnet_from_jax`. flax draws the dropout masks from the step's key and
the port from its own generator, so `jax.random.bernoulli` is wrapped while
the JAX step is traced to hand every mask out through an ordered
`jax.debug.callback`, and the port replays them (`DropoutMasks.replay`).
Three steps on one batch. Held:
- every step's losses (mse, mae, ssim, tot_loss, psnr_loss) within 1e-4
  relative;
- the first step's gradients within 1e-4 of each tensor's max (the JAX ones
  by jax.grad of the JAX step's own loss function, on the same key). Two
  tensors miss that: the biases of the 1x1 head convs, whose gradient is
  one sum over the 2 x 128 x 128 output pixels and reads 4.5e-4 and 7.9e-4
  of its max from JAX's: the rounding of that float32 sum (the port's
  float64 gradient, same masks, the SSIM in float32, is within 1e-6 of the
  port's float32 one; JAX's is the farther from it here, the port's in
  test_torch_osm_train.py). The test holds every tensor to 1e-4 of JAX's,
  or a bias, both sides, to 1e-3 of the port's float64 gradient;
- the weights and the EMA after each step within 1e-5 absolute.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.models import build_model as jax_build_model
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.archs.blocks import DropoutMasks
from satlas_sr_tpu_torch.models import build_model
from satlas_sr_tpu_torch.ops.ssim import ssim_loss
from satlas_sr_tpu_torch.utils.torch_io import highresnet_from_jax, srcnn_from_jax
from test_torch_osm_train import (assert_grads_match, flax_init_from,  # noqa: F401
                                  one_device_mesh)
from torch_threads import two_torch_threads  # noqa: F401

STEPS, T = 3, 4
FROM_JAX = {"SRCNN": srcnn_from_jax, "HighResNet": highresnet_from_jax}
TO_JAX = {"SRCNN": lambda state: jax_torch_io.srcnn_from_torch(state, residual_layers=1),
          "HighResNet": jax_torch_io.highresnet_from_torch}


def small_opt(arch):
    return {
        "name": f"{arch}_small", "model_type": "L2Model", "scale": 4, "manual_seed": 0,
        "is_train": True, "rank": 0, "world_size": 1, "compute_dtype": "float32",
        "datasets": {"train": {"name": "train", "type": "S2NAIPDataset", "n_s2_images": T,
                               "use_3d": True}},
        "network_g": {"type": arch, "in_channels": 3, "mask_channels": 0, "revisits": T,
                      "hidden_channels": 16, "out_channels": 3, "kernel_size": 3,
                      "residual_layers": 1, "output_size": 128, "zoom_factor": 4,
                      "sr_kernel_size": 1},
        "path": {},
        "train": {"ema_decay": 0.999,
                  "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
                  "scheduler": {"type": "MultiStepLR", "milestones": [2], "gamma": 0.5},
                  "total_iter": STEPS, "warmup_iter": -1},
        "val": None,
    }


class RecordedDropout:
    """While active, jax.random.bernoulli hands each mask it returns to
    `masks` (NHWC -> NCHW, slot = call order at trace time) through a
    jax.debug.callback, under jit as well; a jitted function traced meanwhile
    keeps doing so at every call."""

    def __init__(self):
        self.masks = {}
        self._real = jax.random.bernoulli
        self._calls = 0

    def _keep(self, slot, mask):
        self.masks[slot] = torch.from_numpy(np.array(mask)).permute(0, 3, 1, 2)

    def __call__(self, key, p=0.5, shape=None, **kw):
        mask = self._real(key, p, shape, **kw)
        jax.debug.callback(functools.partial(self._keep, self._calls), mask)
        self._calls += 1
        return mask

    def in_order(self):
        return [self.masks[i] for i in sorted(self.masks)]

    def __enter__(self):
        jax.random.bernoulli = self
        return self

    def __exit__(self, *exc):
        jax.random.bernoulli = self._real


def port_float64_grads(pm, batch, masks):
    """The port's first-step gradients in float64 (the SSIM in float32) on
    the recorded masks, from the pre-step weights in `pm.pre_step`."""
    net = copy.deepcopy(pm.net_g).double()
    net.load_state_dict({k: v.double() for k, v in pm.pre_step.items()})
    dm = DropoutMasks()
    dm.replay(masks)
    net.set_dropout_masks(dm)
    lr = torch.from_numpy(batch["lr"]).double() / 255.0
    hr = torch.from_numpy(batch["hr"]).double() / 255.0
    out = net.train()(lr)[:, 0]
    mse_i = (out - hr).square().mean(dim=(1, 2, 3))
    mae_i = (out - hr).abs().mean(dim=(1, 2, 3))
    ssim_i = ssim_loss(out, hr, window_size=5).mean(dim=(1, 2, 3))
    (0.3 * mse_i + 0.4 * mae_i + 0.3 * ssim_i).mean().backward()
    return {n: p.grad for n, p in net.named_parameters()}


@pytest.fixture(scope="module", params=["SRCNN", "HighResNet"])
def run(request):
    arch = request.param
    to_port = FROM_JAX[arch]
    rng = np.random.RandomState(0)
    opt = small_opt(arch)
    pm = build_model(copy.deepcopy(opt), device="cpu")
    with flax_init_from({arch: TO_JAX[arch]({k: v.numpy() for k, v in
                                             pm.net_g.state_dict().items()})}):
        jm = jax_build_model(copy.deepcopy(opt))
    host = jax.device_get(jm.state)
    pm.net_g.load_state_dict(to_port({"params": host["params"]}))
    pm.pre_step = copy.deepcopy(pm.net_g.state_dict())
    for k, v in to_port({"params": host["ema"]}).items():
        pm.ema[k].copy_(v)
    batch = {"lr": (rng.rand(2, T, 32, 32, 3) * 255).astype(np.uint8),
             "hr": (rng.rand(2, 128, 128, 3) * 255).astype(np.uint8)}
    dropout_rng = jax.random.split(host["rng"])[1]  # the first step's key
    grads, _ = jax.jit(jm._worldstrat_grads)(host["params"], jnp.asarray(batch["lr"]),
                                             jnp.asarray(batch["hr"]), dropout_rng)
    rec = {"jax_grads": to_port({"params": jax.device_get(grads)}), "logs": [], "states": [],
           "masks": []}
    with RecordedDropout() as dropout:
        for it in range(1, STEPS + 1):
            dropout.masks.clear()
            want = {k: float(v) for k, v in jm.train_iter(batch, it).items()}
            jax.effects_barrier()
            masks = dropout.in_order()
            pm.dropout_masks.replay(masks)
            got = {k: float(v) for k, v in pm.train_iter(batch, it).items()}
            rec["masks"].append((len(masks), len(pm.dropout_masks.queue)))
            rec["logs"].append((got, want))
            if it == 1:
                rec["port_grads"] = {n: p.grad.clone() for n, p in pm.net_g.named_parameters()}
                rec["port_f64_grads"] = port_float64_grads(pm, batch, masks)
            host = jax.device_get(jm.state)
            rec["states"].append(copy.deepcopy((
                {"g": pm.net_g.state_dict(), "ema": pm.ema},
                {"g": to_port({"params": host["params"]}), "ema": to_port({"params": host["ema"]})})))
    return rec


def test_every_recorded_mask_is_replayed(run):
    for drawn, left in run["masks"]:
        assert drawn == 6 and left == 0  # 3 DoubleConv2d a forward, 2 dropouts each


def test_loss_dicts_match_jax_every_step(run):
    for it, (got, want) in enumerate(run["logs"], 1):
        assert sorted(got) == sorted(want) == ["mae", "mse", "psnr_loss", "ssim", "tot_loss"]
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (it, k, got[k], want[k])


def test_first_step_gradients_match_jax(run):
    assert set(run["port_grads"]) == set(run["jax_grads"])
    assert_grads_match(run["port_grads"], run["jax_grads"], run["port_f64_grads"])


@pytest.mark.parametrize("part", ["g", "ema"])
def test_weights_and_ema_match_jax_after_each_step(run, part):
    for it, (got, want) in enumerate(run["states"], 1):
        assert set(got[part]) == set(want[part])
        for name, ref in want[part].items():
            err = (got[part][name] - ref).abs().max().item()
            assert err <= 1e-5, (it, part, name, err)

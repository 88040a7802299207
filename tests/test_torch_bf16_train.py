"""One train step of the port in `compute_dtype: bfloat16` against the JAX
package's bfloat16 step, on the CPU: the L2 trainer (SRCNN, HighResNet) and
the ESRGAN GAN trainer, as the shipped ESRGAN configs train it.

The configs are the small ones of the float32 tests
(tests/test_torch_l2_train.py: hidden 16, 4 revisits;
tests/test_torch_esrgan_train.py: G nf 8, one block, g 4, U-Net SN D nf 4,
VGG19 to conv1_2) with compute_dtype flipped, on 16 x 16 LR chips (64 x 64
HR; the SRCNN and HighResNet heads' output_size 64). The JAX models (bf16
and f32) start from the port's seeded weights (`flax_init_from`) and take
the same uint8 batch; the L2 steps take the same dropout masks (recorded
from the JAX bf16 step and replayed by the port's `DropoutMasks`; flax
draws the f32 step's from the same key, so they are the same masks). Each
JAX step runs once, jitted, and hands its gradients out through a
jax.debug.callback at the optimizer update.

A bf16 step is not an f32 step: each op rounds its output to bf16. So the
port's bf16 step is held to JAX's bf16 step, with JAX's own f32 step as the
yardstick. For each logged loss, each conv kernel's first gradient, and
each weight, spectral u/v vector and EMA tensor after the step, in relative
L2 against JAX's bf16 value:

    ||port_bf16 - jax_bf16|| <= 0.5 * ||jax_f32 - jax_bf16|| + 1e-6.

The floor of 1e-6 is float32 rounding where both dtypes take equal inputs
(the D's power iteration on float32 weights; the EMA; Adam's first update,
which moves a weight by the lr whatever its gradient's size).

Three rounding orders of the JAX package on XLA's CPU backend are not a
bf16 step's, and the test takes them out:
- a kernel's gradient is a bf16 tensor in the port (cuDNN's and oneDNN's
  bf16 weight gradient); XLA's CPU backend keeps the bf16 conv's weight
  gradient in float32. Kernel gradients are compared rounded to bf16, all
  three alike.
- a bias's or a PReLU slope's gradient is a sum over every pixel of a
  channel: XLA's CPU backend adds a bf16 cotangent in bf16 and stalls once
  the sum outgrows the terms (SRCNN's sr.upsample.4.bias sums to -0.0625,
  against f32's -0.1512 and the port's -0.1514; the port sums in float32,
  as XLA does on a TPU). These gradients, and those weights after the step
  (Adam's update follows their signs), are held to JAX's f32 value instead:
  ||port_bf16 - jax_f32|| <= 0.5 * ||jax_bf16 - jax_f32|| + 1e-6.
- JAX's ResidualDenseBlock trains in its `fused` form: it sums five per-slice
  partial convs, each rounded to bf16 (a batching for the TPU's matrix
  unit). The port's RDB, and its CUDA kernel, is the literal chain (each
  conv over the whole concat, accumulated in float32, rounded once), which
  is the JAX block's `fused=False`: the JAX references run that form.

What the test found (ROADMAP.md queue 3): the port's RRDBNet and U-Net D
took the LeakyReLU slope and the residual scale as float32's 0.2, where the
JAX blocks' constants take the bf16 network's dtype (0.2001953125); the
port's bf16 generator output sat 4.4e-3 (relative L2) from JAX's, against
JAX's own f32 output at 6.0e-3. ops/cuda/rdb.point_two repaired it.
"""

import copy
import functools
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import satlas_sr_tpu.archs.rrdbnet as jax_rrdbnet
from satlas_sr_tpu.models import build_model as jax_build_model
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.models import build_model
from satlas_sr_tpu_torch.utils.torch_io import rrdbnet_from_jax, unet_disc_from_jax
from test_torch_l2_train import FROM_JAX, TO_JAX, RecordedDropout
from test_torch_l2_train import small_opt as l2_opt
from test_torch_osm_train import flax_init_from, one_device_mesh  # noqa: F401
from test_torch_ssim_esrgan_train import small_opt as esrgan_opt
from torch_threads import two_torch_threads  # noqa: F401

FLOOR = 1e-6
LR = 16  # LR rows and columns (x4: 64 x 64 HR)
DTYPES = ("bfloat16", "float32")
#: the JAX package's per-program XLA options (utils/jax_cache.compiler_options),
#: read when a model builds its jitted steps
EXACT_BF16 = {"SSR_TPU_COMPILER_OPTIONS": '{"xla_allow_excess_precision": "False"}'}


def _numpy(state):
    return {k: v.numpy() for k, v in state.items()}


def _with_dtype(opt, dtype):
    opt = copy.deepcopy(opt)
    opt["compute_dtype"] = dtype
    return opt


def _grads_out(jm, attr, sink):
    """Wrap the JAX model's `attr` (its optimizer update: grads second
    argument) so that each call also sends its grads to `sink` from the
    jitted step."""
    real = getattr(jm, attr)

    def wrapped(*args):
        jax.debug.callback(lambda g: sink.append(jax.device_get(g)), args[1])
        return real(*args)

    setattr(jm, attr, wrapped)


def _l2_run(arch):
    """{jax_bfloat16, jax_float32, port_bfloat16}: logs, first gradients,
    weights after the step."""
    rng = np.random.RandomState(0)
    opt = l2_opt(arch)
    opt["network_g"]["output_size"] = 4 * LR
    to_port = FROM_JAX[arch]
    pm = build_model(_with_dtype(opt, "bfloat16"), device="cpu")
    assert pm.dtype == torch.bfloat16
    with flax_init_from({arch: TO_JAX[arch](_numpy(pm.net_g.state_dict()))}), \
            mock.patch.dict(os.environ, EXACT_BF16):
        jms = {d: jax_build_model(_with_dtype(opt, d)) for d in DTYPES}
    batch = {"lr": (rng.rand(2, 4, LR, LR, 3) * 255).astype(np.uint8),
             "hr": (rng.rand(2, 4 * LR, 4 * LR, 3) * 255).astype(np.uint8)}
    out, masks = {}, {}
    with RecordedDropout() as dropout:
        for dtype, jm in jms.items():
            grads = []
            _grads_out(jm, "_finish_step", grads)  # (state, grads, logs, rng)
            dropout.masks.clear()
            logs = {k: float(v) for k, v in jm.train_iter(batch, 1).items()}
            jax.effects_barrier()
            masks[dtype] = dropout.in_order()
            host = jax.device_get(jm.state)
            out[f"jax_{dtype}"] = {
                "logs": logs, "grads": {"g": to_port({"params": grads[0]})},
                "weights": {"g": to_port({"params": host["params"]}),
                            "ema": to_port({"params": host["ema"]})}}
    assert len(masks["bfloat16"]) == 6
    assert all(torch.equal(a, b) for a, b in zip(*masks.values()))
    pm.dropout_masks.replay(masks["bfloat16"])
    logs = {k: float(v) for k, v in pm.train_iter(batch, 1).items()}
    assert not pm.dropout_masks.queue
    out["port_bfloat16"] = {
        "logs": logs, "grads": {"g": {n: p.grad.clone() for n, p in pm.net_g.named_parameters()}},
        "weights": {"g": copy.deepcopy(pm.net_g.state_dict()), "ema": copy.deepcopy(pm.ema)}}
    return out


def _esrgan_run():
    rng = np.random.RandomState(0)
    opt = esrgan_opt()
    del opt["train"]["ssim_opt"]
    pm = build_model(_with_dtype(opt, "bfloat16"), device="cpu")
    assert pm.dtype == torch.bfloat16
    literal_rdb = functools.partial(jax_rrdbnet.ResidualDenseBlock, fused=False)
    with flax_init_from({
            "RRDBNet": jax_torch_io.rrdbnet_from_torch(_numpy(pm.net_g.state_dict()), num_block=1),
            "UNetDiscriminatorSN": jax_torch_io.unet_disc_from_torch(_numpy(pm.net_d.state_dict()))}):
        jms = {d: jax_build_model(_with_dtype(opt, d)) for d in DTYPES}
    batch = {"lr": (rng.rand(2, LR, LR, 6) * 255).astype(np.uint8),
             "hr": (rng.rand(2, 4 * LR, 4 * LR, 3) * 255).astype(np.uint8)}
    out = {}
    with mock.patch.object(jax_rrdbnet, "ResidualDenseBlock", literal_rdb):
        for dtype, jm in jms.items():
            grads = []
            _grads_out(jm, "_apply_opt", grads)  # (tx, grads, opt_state, params): G and D
            with mock.patch.dict(os.environ, EXACT_BF16):
                jm._train_step = jm._build_train_step()
            logs = {k: float(v) for k, v in jax.device_get(jm.train_iter(batch, 1)).items()}
            jax.effects_barrier()
            host = jax.device_get(jm.state)
            g, d = sorted(grads, key=lambda tree: "conv_first" not in tree)
            out[f"jax_{dtype}"] = {
                "logs": logs,
                "grads": {"g": rrdbnet_from_jax({"params": g}),
                          "d": unet_disc_from_jax({"params": d})},
                "weights": {"g": rrdbnet_from_jax({"params": host["g"]["params"]}),
                            "d": unet_disc_from_jax(host["d"]),
                            "ema": rrdbnet_from_jax({"params": host["ema"]})}}
    logs = {k: float(v) for k, v in pm.train_iter(batch, 1).items()}
    out["port_bfloat16"] = {
        "logs": logs,
        "grads": {n: {k: p.grad.clone() for k, p in getattr(pm, f"net_{n}").named_parameters()}
                  for n in ("g", "d")},
        "weights": copy.deepcopy({"g": pm.net_g.state_dict(), "d": pm.net_d.state_dict(),
                                  "ema": pm.net_g_ema.state_dict()})}
    return out


RUNS = {"srcnn": lambda: _l2_run("SRCNN"), "highresnet": lambda: _l2_run("HighResNet"),
        "esrgan": _esrgan_run}


@pytest.fixture(scope="module", params=sorted(RUNS))
def run(request):
    return RUNS[request.param]()


def _rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _channel_sum(name, ref):
    """A bias or a PReLU slope: its gradient sums a whole channel's pixels."""
    return name.endswith("bias") or (ref.ndim == 1 and ref.numel() == 1)


def _cat(tree, names):
    return torch.cat([torch.as_tensor(tree[k], dtype=torch.float64).flatten() for k in names])


def _distances(port, jbf, jf32, sums=True):
    """{group: (port's distance, bound)} of one network's tensors: the
    channel sums, held to JAX's f32 value, and all the others, held to JAX's
    bf16 value (see the module docstring)."""
    assert set(jbf) == set(jf32) and set(jbf) <= set(port)
    groups = {"tensors": [k for k, v in jbf.items() if not _channel_sum(k, v)],
              "channel sums": [k for k, v in jbf.items() if _channel_sum(k, v)] if sums else []}
    out = {}
    for group, names in groups.items():
        if not names:
            continue
        p, b, f = (_cat(t, names) for t in (port, jbf, jf32))
        if group == "channel sums":
            b, f = f, b
        out[group] = (_rel(p, b), 0.5 * _rel(f, b) + FLOOR)
    return out


def test_loss_dict_is_nearer_jax_bf16_than_jax_f32(run):
    port, jbf, jf32 = (run[k]["logs"] for k in ("port_bfloat16", "jax_bfloat16", "jax_float32"))
    assert sorted(port) == sorted(jbf) == sorted(jf32)
    far = {k: (_rel(port[k], jbf[k]), 0.5 * _rel(jf32[k], jbf[k]) + FLOOR) for k in jbf}
    assert all(got <= bound for got, bound in far.values()), {k: v for k, v in far.items() if v[0] > v[1]}


@pytest.mark.parametrize("part", ["grads", "weights"])
def test_gradients_and_weights_are_nearer_jax_bf16_than_jax_f32(run, part):
    nets = run["jax_bfloat16"][part]
    assert nets
    for net, jbf in nets.items():
        # a channel sum's first Adam step is +-lr by its gradient's sign: its
        # gradient is held, its weight after the step is not
        dist = _distances(run["port_bfloat16"][part][net], jbf, run["jax_float32"][part][net],
                          sums=part == "grads")
        assert dist and all(got <= bound for got, bound in dist.values()), (part, net, dist)

"""The port's train step on a dp x sp layout (`spatial_shards`: models/base.py
"Row bands", the differentiable collectives of parallel/halo.py and the band
forwards of G, D, VGG19 and the losses) in four gloo processes on the CPU,
against the JAX package's one-process step on the global batch and the
port's own one-process step, computed here.

One module fixture starts four ranks once (torch.distributed, gloo,
init_method file:// under the fixture's tmp dir; each rank with its own
deadline) and runs every leg at `__graft_entry__.dryrun_opt`'s sizes (G nf
8, one block, grow 4; D nf 4; VGG19 to conv1_2; LR 32 x 32, HR 128 x 128)
in float32, on the layouts dp 1 x sp 4 and dp 2 x sp 2. Each rank writes
its results to disk. Meanwhile this process and two more (`jax_worker`:
the L2 legs, whose masks the ranks wait for, and the accumulated leg) run
the JAX trainer of each leg from the port's seeded weights
(`flax_init_from`) on one JAX device on the global batch
(the data groups' rows in group order; with accum_steps k, micro-batch j
of the global batch is every group's micro-batch j), and the port's
one-process step on the same batch. The legs:
(a) the differentiable exchange, gather and sum: the bands' gradients of a
    non-linear function of the exchanged rows (halos 1, 2 and 5), of the
    gathered image and of the summed bands equal the whole image's
    autograd bit for bit (small integers: every sum is exact in float32);
(b) the U-Net D and VGG19 band forwards and backwards against the whole
    image's: logits, taps, input gradients and the bands' parameter
    gradients summed, within 1e-5 of each tensor's max; u/v equal;
(c) one ESRGAN step at dp 1 x sp 4 and dp 2 x sp 2: the logs within rtol
    2e-4 / atol 2e-5 of JAX's (tests/test_spatial.py's dp x sp bar), the
    G and D gradients within 1e-4 of each tensor's max of jax.grad's and
    within 1e-5 of the port's one-process step's (D's last bias, one
    cancelling sum, against its float64 sum: `_grads_close`), the four
    replicas' G, D, u/v, EMA and Adam states bit-equal;
(d) ESRGAN with accum_steps 2 at dp 2 x sp 2 and an OSM-object step at
    dp 2 x sp 2 whose boxes cross the band edge (each data group draws its
    own chips' boxes, as each JAX process does): logs against JAX, the
    weights and u/v after the step against JAX's to chip_smoke phase 14's
    bar (`_weights_close`), the EMA within 1e-4 of each tensor's max
    (+1e-6), gradients within 1e-5 of the port's one-process step,
    replicas bit-equal;
(e) L2 SRCNN and HighResNet steps at sp 4 with dropout on (JAX's masks,
    drawn for the global batch, replayed: each rank keeps its rows of its
    band) in tests/test_spatial.py's config (two revisits, hidden 16):
    logs and weights against JAX, gradients against the port's
    one-process step; and the eval forward's uint8 output (bands gathered)
    against JAX's eval after the step, within one level;
(f) SSIMLoss, the perceptual style term and the CLIP loss (test-tiny
    tower) at dp 2 x sp 2 against the port's one-process step (gradients
    within 1e-5 of each tensor's max): halo rows of the SSIM window, the
    Gram matrices summed over the group, the tower on the gathered image;
(g) remat block and rdb on bands bit-equal to no remat; the refusal of an
    LR band of 4 rows (S = 4 on 16 LR rows; the RDB halo needs 5).
"""

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD, TIMEOUT = 4, 240
# leg -> (spatial_shards, data groups, rows a data group a micro-batch, micro-batches)
LEGS = {"esrgan_sp4": (4, 1, 2, 1), "esrgan_dp2sp2": (2, 2, 1, 1),
        "accum_dp2sp2": (2, 2, 1, 2), "osm_dp2sp2": (2, 2, 1, 1),
        "srcnn_sp4": (4, 1, 2, 1), "highresnet_sp4": (4, 1, 2, 1),
        "terms_dp2sp2": (2, 2, 1, 1)}
L2_LEGS = ("srcnn_sp4", "highresnet_sp4")
# held to the port's one-process step only (test_torch_clip_train and
# test_torch_ssim_esrgan_train hold that to JAX): SSIMLoss, the style term
# and the CLIP loss on bands
PORT_ONLY = ("terms_dp2sp2",)
# every box of these chips crosses row 64, the band edge at dp 2 x sp 2
OSM = {"700_800": {"building": [[10, 50, 40, 80], [60, 40, 90, 100]]},
       "701_801": {"road": [[0, 60, 128, 70]]}}


# -- the ranks -------------------------------------------------------------------


def _snapshot(model):
    """Every tensor a replica holds after a step, and its gradients."""
    def grads(net):
        return {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None}

    out = {"g": model.net_g.state_dict(), "opt_g": model.opt_g.state_dict()["state"],
           "grad_g": grads(model.net_g)}
    if hasattr(model, "net_d"):
        out.update(d=model.net_d.state_dict(), opt_d=model.opt_d.state_dict()["state"],
                   ema=model.net_g_ema.state_dict(), grad_d=grads(model.net_d))
    else:
        out["ema"] = dict(model.ema)
    return {k: {str(n): (t.clone() if isinstance(t, torch.Tensor) else
                         {m: u.clone() for m, u in t.items()}) for n, t in v.items()}
            for k, v in out.items()}


def _group_rows(batch, leg, group):
    """A data group's rows of the global batch (module docstring)."""
    _, _, b, k = LEGS[leg]
    groups = LEGS[leg][1]
    rows = [j * b * groups + group * b + i for j in range(k) for i in range(b)]
    return {key: (np.asarray(v)[rows] if key != "Chip" else [str(v[r]) for r in rows])
            for key, v in batch.items()}


def _wait_for(path):
    for _ in range(TIMEOUT * 10):  # written by the test process once its JAX step ran
        if os.path.exists(path):
            return
        time.sleep(0.1)
    raise TimeoutError(path)


def _step_leg(work, leg):
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.parallel import mesh

    with open(os.path.join(work, f"{leg}.json")) as f:
        opt = json.load(f)
    model = build_model({**opt, "world_size": WORLD, "spatial_shards": LEGS[leg][0]},
                        device="cpu")
    batch = dict(np.load(os.path.join(work, f"{leg}.npz")))
    group = model.space.data_index
    if leg in L2_LEGS:
        path = os.path.join(work, f"{leg}_masks.pt")
        _wait_for(path)
        model.dropout_masks.replay(torch.load(path))
    logs = {k: float(v) for k, v in model.train_iter(_group_rows(batch, leg, group), 1).items()}
    out = {"logs": logs, "state": _snapshot(model), "layout": tuple(model.space[:4])}
    if leg in L2_LEGS:
        out["eval"] = model.eval_outputs({"lr": _group_rows(batch, leg, group)["lr"]}).numpy()
    mesh.barrier()
    return out


def _collective_leg(work, space4):
    """(a): the bands' gradients of functions of the exchanged, gathered and
    summed rows; the whole image's are computed by the test process."""
    from satlas_sr_tpu_torch.parallel.halo import all_reduce_sum, exchange_rows, gather_rows

    x = torch.from_numpy(np.load(os.path.join(work, "ints.npy")))
    r0, r1 = space4.band(x.shape[1])
    out = {}
    for n in (1, 2, 5):
        band = x[:, r0:r1].clone().requires_grad_(True)
        ext, top, bottom = exchange_rows(band, n, space4)
        _stencil_loss(ext, top, bottom, n, band.shape[1]).backward()
        out[f"exchange{n}"] = band.grad.numpy()
    band = x[:, r0:r1].clone().requires_grad_(True)
    _gather_loss(gather_rows(band, space4)).backward()
    out["gather"] = band.grad.numpy()
    band = x[:, r0:r1].clone().requires_grad_(True)
    (all_reduce_sum(band, space4) ** 2).sum().backward()
    out["sum"] = band.grad.numpy()
    return out


def _stencil_loss(ext, top, bottom, n, h):
    """sum over the band's rows r of (sum_k (k + 1) x[r + k - n])^2 on rows
    zero-padded at the image's border: non-linear, integer-exact."""
    parts = [ext.new_zeros((ext.shape[0], n - top) + ext.shape[2:]), ext,
             ext.new_zeros((ext.shape[0], n - bottom) + ext.shape[2:])]
    padded = torch.cat(parts, 1)
    y = sum((k + 1) * padded[:, k:k + h] for k in range(2 * n + 1))
    return (y * y).sum()


def _gather_loss(whole):
    w = torch.arange(whole.shape[1], dtype=whole.dtype).reshape(1, -1, 1, 1) % 3
    return (w * whole * whole).sum()


def _band_net_leg(work, space):
    """(b): the U-Net D and the VGG19 taps on this rank's band, forward and
    backward."""
    from satlas_sr_tpu_torch.archs import UNetDiscriminatorSN
    from satlas_sr_tpu_torch.losses.vgg import init_vgg19_params, torch_params, vgg19_features

    x = torch.from_numpy(np.load(os.path.join(work, "img.npy")))
    r0, r1 = space.band(x.shape[1])
    d = UNetDiscriminatorSN(5, 4, seed=3, device="cpu")
    band = x[:, r0:r1].clone().requires_grad_(True)
    logits = d.forward_band(band, space, update_stats=True)
    (logits * logits).sum().backward()
    out = {"d_logits": logits.detach().numpy(), "d_dx": band.grad.numpy(),
           "d_grads": {n: p.grad.numpy() for n, p in d.named_parameters()},
           "d_uv": {n: b.numpy() for n, b in d.named_buffers()}}
    params = torch_params(init_vgg19_params(0))
    for p in params.values():
        for t in p:
            t.requires_grad_(True)
    band = x[:, r0:r1, :, :3].clone().requires_grad_(True)
    taps = vgg19_features(params, band, ["conv1_2", "conv2_2", "conv3_1"], space=space)
    sum((t * t).mean() for t in taps.values()).backward()
    out.update(vgg_taps={k: t.detach().numpy() for k, t in taps.items()},
               vgg_dx=band.grad.numpy(),
               vgg_grads={k: p[0].grad.numpy() for k, p in params.items() if p[0].grad is not None})
    return out


def _refusal_leg(work):
    from satlas_sr_tpu_torch.models import build_model

    with open(os.path.join(work, "esrgan_sp4.json")) as f:
        opt = {**json.load(f), "world_size": WORLD, "spatial_shards": 4}
    rng = np.random.RandomState(0)
    model = build_model(opt, device="cpu")
    try:
        model.train_iter({"lr": (rng.rand(1, 16, 16, 6) * 255).astype(np.uint8),
                          "hr": (rng.rand(1, 64, 64, 3) * 255).astype(np.uint8)}, 1)
    except ValueError as e:
        return str(e)
    return None


def _remat_leg(work):
    """The sp 4 ESRGAN step with each remat mode: logs and gradients."""
    from satlas_sr_tpu_torch.models import build_model

    with open(os.path.join(work, "esrgan_sp4.json")) as f:
        opt = {**json.load(f), "world_size": WORLD, "spatial_shards": 4}
    batch = dict(np.load(os.path.join(work, "esrgan_sp4.npz")))
    out = {}
    for mode in (False, True, "rdb"):
        model = build_model({**opt, "network_g": {**opt["network_g"], "remat": mode}},
                            device="cpu")
        logs = {k: float(v) for k, v in model.train_iter(batch, 1).items()}
        out[str(mode)] = (logs, {n: p.grad.clone() for n, p in model.net_g.named_parameters()})
    return out


def worker(rank: int, work: str) -> None:
    """Rank `rank` of the four: every leg, results under `work`."""
    import torch.distributed as dist

    from satlas_sr_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(WORLD))
    dist.init_process_group("gloo", init_method=f"file://{work}/init", rank=rank,
                            world_size=WORLD)
    try:
        space4, space2 = mesh.mesh_2d(4), mesh.mesh_2d(2)
        out = {"collectives": _collective_leg(work, space4),
               "nets": {name: _band_net_leg(work, sp) for name, sp in
                        (("sp4", space4), ("sp2", space2))}}
        for leg in LEGS:
            out[leg] = _step_leg(work, leg)
        out["refused"] = _refusal_leg(work)
        out["remat"] = _remat_leg(work)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the test process: inputs, the ranks, the references ---------------------------


def _opts(work):
    from test_torch_clip_train import small_opt as clip_opt
    from test_torch_esrgan_train import small_opt as esrgan_opt
    from test_torch_l2_train import small_opt as l2_opt
    from test_torch_osm_train import small_opt as osm_opt
    from pathlib import Path

    osm_path = os.path.join(work, "osm_chips_to_masks.json")
    with open(osm_path, "w") as f:
        json.dump(OSM, f)
    opts = {"esrgan_sp4": esrgan_opt(Path(work)), "osm_dp2sp2": osm_opt(osm_path)}
    opts["esrgan_dp2sp2"] = opts["accum_dp2sp2"] = opts["esrgan_sp4"]
    for leg, arch in (("srcnn_sp4", "SRCNN"), ("highresnet_sp4", "HighResNet")):
        opt = l2_opt(arch)
        opt["datasets"]["train"]["n_s2_images"] = opt["network_g"]["revisits"] = 2
        opts[leg] = opt
    terms = clip_opt()
    terms["train"]["ssim_opt"] = {"type": "SSIMLoss", "loss_weight": 1.0}
    terms["train"]["perceptual_opt"]["style_weight"] = 0.5
    opts["terms_dp2sp2"] = terms
    opts = json.loads(json.dumps(opts))
    opts["accum_dp2sp2"]["train"]["accum_steps"] = 2
    return opts


def _batches(opts):
    rng = np.random.RandomState(12)
    out = {}
    for leg, (_, groups, b, k) in LEGS.items():
        rows = groups * b * k
        lr = (2, 32, 32, 3) if leg in L2_LEGS else (32, 32, 6)
        out[leg] = {"lr": (rng.rand(rows, *lr) * 255).astype(np.uint8),
                    "hr": (rng.rand(rows, 128, 128, 3) * 255).astype(np.uint8)}
    out["esrgan_dp2sp2"] = out["esrgan_sp4"]  # one global batch, two layouts
    out["osm_dp2sp2"]["Chip"] = np.asarray(sorted(OSM))
    return out


def _numpy(state):
    return {k: v.numpy() for k, v in state.items()}


def _port_one_process(opt, batch, masks=None):
    """The port's step on the global batch in this process (world 1)."""
    from satlas_sr_tpu_torch.models import build_model

    model = build_model(json.loads(json.dumps(opt)), device="cpu")
    if masks is not None:
        model.dropout_masks.replay(masks)
    d_terms = []
    if hasattr(model, "cri_gan"):  # D's per-pixel logits, for `d_bias_float64`
        gan = model.cri_gan

        def cri_gan(logits, target_is_real, is_disc=False):
            if is_disc and logits.shape[1] > 2:
                d_terms.append((logits.detach().double(), float(target_is_real)))
            return gan(logits, target_is_real, is_disc)

        model.cri_gan = cri_gan
    if "Chip" in batch:  # each data group draws its own chips' boxes
        draw, seed = model._sample_boxes, (int(opt["manual_seed"]) * 7919 + 1) % (2 ** 31 - 1)
        boxes = np.concatenate([draw([c], np.random.RandomState(seed)) for c in batch["Chip"]])
        model._sample_boxes = lambda chips, rng: boxes
        batch = {**batch, "Chip": [str(c) for c in batch["Chip"]]}
    logs = {k: float(v) for k, v in model.train_iter(batch, 1).items()}
    out = {"logs": logs, "state": _snapshot(model)}
    if d_terms:  # vanilla BCE mean: d/dz = (sigmoid(z) - label) / N, summed in float64
        out["d_bias_float64"] = sum((torch.sigmoid(z) - y).mean() for z, y in d_terms) \
            / model.accum_steps
    if masks is not None:
        out["eval"] = model.eval_outputs({"lr": batch["lr"]}).numpy()
    return out


def _jax_grads_and_logs(jm, batch):
    """jax.grad of the JAX step's G and D loss functions at its state (as
    test_torch_esrgan_train's `_jax_first_grads`) and the step's logs, in
    one jit: the G and D gradients in the port's names and the loss dict."""
    import jax
    import jax.numpy as jnp

    from satlas_sr_tpu_torch.utils.torch_io import rrdbnet_from_jax, unet_disc_from_jax

    def grads(state, lr_u8, hr_u8):
        lr, old_hr, l1_gt, percep_gt, gan_gt, lr_resized = jm._prep_step_inputs(lr_u8, hr_u8, None)
        d_params, spectral = state["d"]["params"], state["d"]["spectral"]
        g_grads, (g_logs, out, spec1) = jax.grad(
            lambda p: jm._g_loss_and_aux(p, lr, l1_gt, percep_gt, lr_resized, old_hr,
                                         d_params, spectral), has_aux=True)(state["g"]["params"])
        real_in = jm._disc_input(gan_gt, lr_resized, old_hr)
        fake_in = jm._disc_input(jax.lax.stop_gradient(out), lr_resized, old_hr)
        d_grads, (d_logs, _) = jax.grad(lambda p: jm._d_loss_and_aux(p, real_in, fake_in, spec1),
                                        has_aux=True)(d_params)
        return g_grads, d_grads, {**g_logs, **d_logs}

    g, d, logs = jax.device_get(jax.jit(grads)(jm.state, jnp.asarray(batch["lr"]),
                                               jnp.asarray(batch["hr"])))
    return (rrdbnet_from_jax({"params": g}), unet_disc_from_jax({"params": d})), logs


def jax_worker(work: str, legs: str) -> None:
    """The JAX references of `legs` (comma-separated) in a process of their
    own, beside the test process's, written under `work`."""
    with open(os.path.join(work, "opts.json")) as f:
        opts = json.load(f)
    batches = {leg: dict(np.load(os.path.join(work, f"{leg}.npz"))) for leg in legs.split(",")}
    out = _jax_references(work, opts, batches)
    path = os.path.join(work, f"jax_{legs.replace(',', '_')}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def _jax_references(work, opts, batches):
    """{leg: {logs, state or grads, [eval], [masks]}} of the JAX trainer's
    one-process step on each of `batches`' legs' global batch; writes the
    L2 legs' masks first."""
    from unittest import mock

    import jax
    from jax.sharding import Mesh

    import satlas_sr_tpu.models.base as jax_base
    from satlas_sr_tpu.models import build_model as jax_build_model
    from satlas_sr_tpu.utils import torch_io as jax_torch_io
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.utils.torch_io import (highresnet_from_jax, osm_disc_from_jax,
                                                    osm_disc_to_reference, rrdbnet_from_jax,
                                                    srcnn_from_jax, unet_disc_from_jax)
    from test_torch_l2_train import TO_JAX, RecordedDropout
    from test_torch_osm_train import flax_init_from

    from_jax = {"SRCNN": srcnn_from_jax, "HighResNet": highresnet_from_jax}
    out = {}
    one_device = mock.patch.object(jax_base, "data_mesh",
                                   lambda: Mesh(np.array(jax.devices()[:1]), ("data",)))
    with one_device:
        for leg in [leg for leg in L2_LEGS if leg in batches]:
            opt = opts[leg]
            arch = opt["network_g"]["type"]
            pm = build_model(json.loads(json.dumps(opt)), device="cpu")
            with flax_init_from({arch: TO_JAX[arch](_numpy(pm.net_g.state_dict()))}):
                jm = jax_build_model(json.loads(json.dumps(opt)))
            with RecordedDropout() as dropout:
                logs = jm.train_iter(batches[leg], 1)
                jax.effects_barrier()
            masks = dropout.in_order()
            torch.save(masks, os.path.join(work, f"{leg}_masks.pt.tmp"))
            os.replace(os.path.join(work, f"{leg}_masks.pt.tmp"),
                       os.path.join(work, f"{leg}_masks.pt"))
            host = jax.device_get(jm.state)
            out[leg] = {"logs": logs,
                        "eval": np.asarray(jm.eval_outputs({"lr": batches[leg]["lr"]})),
                        "state": {"g": from_jax[arch]({"params": host["params"]}),
                                  "ema": from_jax[arch]({"params": host["ema"]})}}
        for leg in [leg for leg in ("esrgan_sp4", "accum_dp2sp2", "osm_dp2sp2")
                    if leg in batches]:
            opt = opts[leg]
            pm = build_model(json.loads(json.dumps(opt)), device="cpu")
            if leg.startswith("osm"):
                d_cls, d_from = "OSMObjDiscriminator", osm_disc_from_jax
                d_init = jax_torch_io.osm_disc_from_torch(
                    _numpy(osm_disc_to_reference(pm.net_d.state_dict())))
            else:
                d_cls, d_from = "UNetDiscriminatorSN", unet_disc_from_jax
                d_init = jax_torch_io.unet_disc_from_torch(_numpy(pm.net_d.state_dict()))
            with flax_init_from({"RRDBNet": jax_torch_io.rrdbnet_from_torch(
                    _numpy(pm.net_g.state_dict()), num_block=1), d_cls: d_init}):
                jm = jax_build_model(json.loads(json.dumps(opt)))
            batch = dict(batches[leg])
            if leg == "esrgan_sp4":  # grads and logs, no update
                out[leg] = dict(zip(("grads", "logs"), _jax_grads_and_logs(jm, batch)))
                continue
            rec = {}
            if "Chip" in batch:  # each JAX process draws its own chips' boxes
                seed = (int(opt["manual_seed"]) * 7919 + 1) % (2 ** 31 - 1)
                boxes = np.concatenate([jm._sample_boxes([str(c)], np.random.RandomState(seed))
                                        for c in batch["Chip"]])
                jm._sample_boxes = lambda chips, rng: boxes
                batch["Chip"] = [str(c) for c in batch["Chip"]]
                rec["boxes"] = boxes
            rec["logs"] = jm.train_iter(batch, 1)
            host = jax.device_get(jm.state)
            rec["state"] = {"g": rrdbnet_from_jax({"params": host["g"]["params"]}),
                            "d": d_from(host["d"]),
                            "ema": rrdbnet_from_jax({"params": host["ema"]})}
            out[leg] = rec
    for rec in out.values():
        rec["logs"] = {k: float(v) for k, v in jax.device_get(rec["logs"]).items()}
    return out


def _whole_image_references(work):
    """(a) and (b) on the whole image, in this process."""
    from satlas_sr_tpu_torch.archs import UNetDiscriminatorSN
    from satlas_sr_tpu_torch.losses.vgg import init_vgg19_params, torch_params, vgg19_features

    x = torch.from_numpy(np.load(os.path.join(work, "ints.npy")))
    out = {}
    for n in (1, 2, 5):
        whole = x.clone().requires_grad_(True)
        _stencil_loss(whole, 0, 0, n, whole.shape[1]).backward()
        out[f"exchange{n}"] = whole.grad.numpy()
    whole = x.clone().requires_grad_(True)
    _gather_loss(whole).backward()
    out["gather"] = whole.grad.numpy()
    whole = x.clone().requires_grad_(True)
    bands = whole.reshape(x.shape[0], 4, -1, *x.shape[2:])
    (bands.sum(1, keepdim=True).expand_as(bands) ** 2).sum().backward()
    out["sum"] = whole.grad.numpy()

    img = torch.from_numpy(np.load(os.path.join(work, "img.npy")))
    d = UNetDiscriminatorSN(5, 4, seed=3, device="cpu")
    whole = img.clone().requires_grad_(True)
    logits = d(whole, update_stats=True)
    (logits * logits).sum().backward()
    out.update(d_logits=logits.detach().numpy(), d_dx=whole.grad.numpy(),
               d_grads={n: p.grad.numpy() for n, p in d.named_parameters()},
               d_uv={n: b.numpy() for n, b in d.named_buffers()})
    params = torch_params(init_vgg19_params(0))
    for p in params.values():
        for t in p:
            t.requires_grad_(True)
    whole = img[..., :3].clone().requires_grad_(True)
    taps = vgg19_features(params, whole, ["conv1_2", "conv2_2", "conv3_1"])
    sum((t * t).mean() for t in taps.values()).backward()
    out.update(vgg_taps={k: t.detach().numpy() for k, t in taps.items()},
               vgg_dx=whole.grad.numpy(),
               vgg_grads={k: p[0].grad.numpy() for k, p in params.items() if p[0].grad is not None})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("torch_spatial_train"))
    opts = _opts(work)
    batches = _batches(opts)
    for leg, opt in opts.items():
        with open(os.path.join(work, f"{leg}.json"), "w") as f:
            json.dump(opt, f)
        np.savez(os.path.join(work, f"{leg}.npz"), **batches[leg])
    with open(os.path.join(work, "opts.json"), "w") as f:
        json.dump(opts, f)
    rng = np.random.RandomState(5)
    np.save(os.path.join(work, "ints.npy"), rng.randint(-3, 4, (2, 24, 5, 3)).astype(np.float32))
    np.save(os.path.join(work, "img.npy"), rng.rand(2, 64, 24, 5).astype(np.float32))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [HERE, ROOT, os.environ.get("PYTHONPATH", "")])}
    code = "import sys, test_torch_spatial_train as t; t.worker(int(sys.argv[1]), sys.argv[2])"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), work], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    # the JAX references of the L2 legs (whose masks the ranks wait for) and of
    # the accumulated leg in two processes of their own, beside this one's
    groups = (L2_LEGS, ("accum_dp2sp2",))
    side = sum(groups, ())
    code = "import sys, test_torch_spatial_train as t; t.jax_worker(sys.argv[1], sys.argv[2])"
    procs += [subprocess.Popen([sys.executable, "-c", code, work, ",".join(legs)], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for legs in groups]
    try:
        jax_ref = _jax_references(work, opts, {leg: batches[leg] for leg in LEGS
                                               if leg not in side + ("esrgan_dp2sp2",)})
        jax_ref["esrgan_dp2sp2"] = jax_ref["esrgan_sp4"]
        port = {leg: _port_one_process(opts[leg], batches[leg])
                for leg in LEGS if leg not in side + ("esrgan_dp2sp2",)}
        port["esrgan_dp2sp2"] = port["esrgan_sp4"]
        for leg in side:
            masks = None
            if leg in L2_LEGS:
                _wait_for(os.path.join(work, f"{leg}_masks.pt"))
                masks = torch.load(os.path.join(work, f"{leg}_masks.pt"))
            port[leg] = _port_one_process(opts[leg], batches[leg], masks)
        whole = _whole_image_references(work)
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:  # a hung or failed rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{'rank %d' % r if r < WORLD else 'JAX'} failed:\n{text[-4000:]}"
    for legs in groups:
        with open(os.path.join(work, f"jax_{'_'.join(legs)}.pkl"), "rb") as f:
            jax_ref.update(pickle.load(f))
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "jax": jax_ref, "port": port, "whole": whole}


def _close(got, want, rel, what, floor=0.0):
    for name, ref in want.items():
        ref = torch.as_tensor(ref)
        err = (torch.as_tensor(got[name]) - ref).abs().max().item()
        assert err <= rel * ref.abs().max().item() + floor, (what, name, err,
                                                             ref.abs().max().item())


def _grads_close(got, want, rel, what, exact):
    """Each gradient within `rel` of its reference's max. D's last bias is
    one sum of cancelling terms over 2 x 128 x 128 logits (its max ~1e-3 of
    the terms' sum), which float32 rounds differently in every order (the
    port's one-process step and JAX differ there by 8e-4 of its max): it is
    held instead, both sides, within 1e-3 of its max of the float64 sum of
    those terms (`exact`), as tests/test_torch_osm_train.py holds it."""
    assert set(want) <= set(got)
    for name, ref in want.items():
        scale = ref.abs().max().item() + 1e-12
        err = (got[name] - ref).abs().max().item()
        if err <= rel * scale:
            continue
        assert name.endswith("conv9.bias"), (what, name, err / scale)
        for side in (got[name], ref):
            assert (side.double() - exact).abs().max().item() <= 1e-3 * scale, (what, name)


def _weights_close(got, want, grads, lr, what):
    """Weights after one Adam step, chip_smoke phase 14's bar: within rtol
    1e-4 / atol 2e-5 where the gradient is above its tensor's noise floor
    (1e-4 of its max); below it two reduction orders round a gradient of
    ~1e-8 to either sign and Adam's first step turns it into +-lr, so
    there within 2 lr."""
    for name, ref in want.items():
        d = (got[name] - ref).abs()
        off = d > 2e-5 + 1e-4 * ref.abs()
        if not off.any():
            continue
        g = grads.get(name)
        assert g is not None, (what, name, d.max().item())
        quiet = g.abs() <= 1e-4 * g.abs().max()
        assert bool((quiet | ~off).all()), (what, name, d[off & ~quiet].max().item())
        assert d[off].max().item() <= 2 * lr * (1 + 1e-3), (what, name)


@pytest.mark.parametrize("what", ["exchange1", "exchange2", "exchange5", "gather", "sum"])
def test_collective_gradients_equal_whole_image_autograd(run, what):
    got = np.concatenate([rank["collectives"][what] for rank in run["ranks"]], axis=1)
    want = run["whole"][what]
    if what == "gather":  # each rank's copy of the gathered term: S x its gradient
        want = 4 * want
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["sp4", "sp2"])
@pytest.mark.parametrize("net", ["d", "vgg"])
def test_band_forward_and_backward_match_whole_image(run, net, layout):
    s = 4 if layout == "sp4" else 2
    ranks = run["ranks"][:s]  # one data group
    whole = run["whole"]
    nets = [rank["nets"][layout] for rank in ranks]
    if net == "d":
        outs = {"logits": ("d_logits", 1), "dx": ("d_dx", 1)}
        for key, (name, axis) in outs.items():
            got = np.concatenate([n[name] for n in nets], axis)
            _close({key: got}, {key: whole[name]}, 1e-5, (net, layout))
        grads = {k: sum(n["d_grads"][k] for n in nets) for k in whole["d_grads"]}
        _close(grads, whole["d_grads"], 1e-5, (net, layout, "grads"))
        for n in nets:
            for k, v in whole["d_uv"].items():
                np.testing.assert_array_equal(n["d_uv"][k], v)
    else:
        for tap, want in whole["vgg_taps"].items():
            got = np.concatenate([n["vgg_taps"][tap] for n in nets], 2)
            _close({tap: got}, {tap: want}, 1e-5, (net, layout))
        got = np.concatenate([n["vgg_dx"] for n in nets], 1) / s  # band means: S x the share
        _close({"dx": got}, {"dx": whole["vgg_dx"]}, 1e-5, (net, layout))
        grads = {k: sum(n["vgg_grads"][k] for n in nets) / s for k in whole["vgg_grads"]}
        _close(grads, whole["vgg_grads"], 1e-5, (net, layout, "grads"))


def _check_logs(got, want):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k, v in want.items():
        assert abs(got[k] - v) <= 2e-4 * abs(v) + 2e-5, (k, got[k], v)


@pytest.mark.parametrize("leg", [leg for leg in LEGS if leg not in PORT_ONLY])
def test_step_logs_match_jax_on_the_global_batch(run, leg):
    want = run["jax"][leg]["logs"]
    for r, rank in enumerate(run["ranks"]):
        _check_logs(rank[leg]["logs"], want)
    _check_logs(run["port"][leg]["logs"], want)


@pytest.mark.parametrize("leg", ["esrgan_sp4", "esrgan_dp2sp2"])
@pytest.mark.parametrize("net", ["g", "d"])
def test_esrgan_gradients_match_jax_and_one_process(run, leg, net):
    want = run["jax"][leg]["grads"][0 if net == "g" else 1]
    one = run["port"][leg]["state"][f"grad_{net}"]
    exact = run["port"][leg]["d_bias_float64"]
    for rank in run["ranks"]:
        got = rank[leg]["state"][f"grad_{net}"]
        _grads_close(got, want, 1e-4, (leg, net, "jax"), exact)
        _grads_close(got, one, 1e-5, (leg, net, "one process"), exact)


@pytest.mark.parametrize("leg", ["accum_dp2sp2", "osm_dp2sp2", "srcnn_sp4", "highresnet_sp4"])
def test_step_weights_match_jax_and_gradients_one_process(run, leg):
    want = run["jax"][leg]["state"]
    one = run["port"][leg]["state"]
    lr = 1e-4  # optim_g's and optim_d's
    for rank in run["ranks"]:
        got = rank[leg]["state"]
        for part, tensors in want.items():
            grads = one.get(f"grad_{part}", {})
            if part == "ema":  # one Adam step, decay 0.999: the EMA moves 1e-3 of it
                _close(got[part], tensors, 1e-4, (leg, part), 1e-6)
            else:
                _weights_close(got[part], tensors, grads, lr, (leg, part))
        for part in ("grad_g", "grad_d"):
            if part in one:
                _grads_close(got[part], one[part], 1e-5, (leg, part),
                             run["port"][leg].get("d_bias_float64"))
    if leg == "osm_dp2sp2":  # the drawn boxes cross the band edge at row 64
        boxes = run["jax"][leg]["boxes"]
        assert ((boxes[..., 1] < 64) & (boxes[..., 3] > 64)).all()


@pytest.mark.parametrize("leg", list(LEGS))
def test_replicas_bit_equal_after_the_step(run, leg):
    first = run["ranks"][0][leg]
    for rank in run["ranks"][1:]:
        other = rank[leg]
        assert other["logs"] == first["logs"]
        for part, tensors in first["state"].items():
            if part.startswith("grad_"):
                continue
            for name, t in tensors.items():
                o = other["state"][part][name]
                if isinstance(t, dict):  # an Adam state: exp_avg, exp_avg_sq, step
                    assert all(torch.equal(t[m], o[m]) for m in t), (leg, part, name)
                else:
                    assert torch.equal(t, o), (leg, part, name)
    s, groups = LEGS[leg][:2]
    assert [rank[leg]["layout"] for rank in run["ranks"]] == \
        [(r % s, s, r // s, groups) for r in range(WORLD)]


def test_ssim_style_and_clip_terms_match_one_process(run):
    """SSIMLoss (halo rows of the window), the style term (Gram matrices
    summed over the group) and the CLIP loss (the tower on the gathered
    image, every rank of the group, counted once) at dp 2 x sp 2."""
    one = run["port"]["terms_dp2sp2"]
    assert {"l_g_ssim", "l_g_style", "l_clip_sim"} <= set(one["logs"])
    for rank in run["ranks"]:
        got = rank["terms_dp2sp2"]
        _check_logs(got["logs"], one["logs"])
        for part in ("grad_g", "grad_d"):
            _grads_close(got["state"][part], one["state"][part], 1e-5, part,
                         one["d_bias_float64"])


@pytest.mark.parametrize("leg", L2_LEGS)
def test_eval_forward_on_bands_matches_jax(run, leg):
    want = run["jax"][leg]["eval"]
    for rank in run["ranks"]:
        got = rank[leg]["eval"]
        assert got.shape == want.shape == (2, 128, 128, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        np.testing.assert_array_equal(got, run["port"][leg]["eval"])


def test_layouts_that_cannot_split_are_refused(run):
    for rank in run["ranks"]:
        short = rank["refused"]
        assert short is not None and "16 rows do not split into 4 bands" in short, short
        assert "at least 5" in short


@pytest.mark.parametrize("mode", ["True", "rdb"])
def test_remat_on_bands_is_bit_equal_to_no_remat(run, mode):
    """remat block and rdb rerun the band blocks, halo exchanges included, in
    the backward of every rank of the group: the same logs and gradients."""
    for rank in run["ranks"]:
        (ref_logs, ref), (logs, got) = rank["remat"]["False"], rank["remat"][mode]
        assert logs == ref_logs
        assert all(torch.equal(got[n], g) for n, g in ref.items())

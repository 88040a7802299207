"""The port's data parallelism (parallel/mesh.py and its users) in two gloo
processes on the CPU, against the JAX package's one-process step on the
global batch, computed here.

One module fixture starts two ranks once (torch.distributed, gloo,
init_method file:// under the fixture's tmp dir, so xdist workers never race
for a port; each rank with its own timeout) and runs every leg at small
width in float32, each rank writing its results to disk. Meanwhile this
process computes the JAX references: the JAX trainer of each leg started
from the port's seeded weights (`flax_init_from`), one `train_iter` on the
ranks' rows concatenated in rank order (with accum_steps k, micro-batch j
of the global batch is every rank's micro-batch j, as the JAX package's
multi-process step assembles it). The legs:
- an L2 SRCNN step with dropout (the JAX step's global masks replayed on
  both ranks, each keeping its rows), an ESRGAN GAN step, ESRGAN with
  accum_steps 2 and an OSM-object step (each rank draws its own chips'
  boxes, as each JAX process does; the JAX step is handed those boxes).
  Held: losses within 1e-4 relative; G, D (u/v included) and the EMA
  within 1e-4 of each tensor's max (+1e-6, test_torch_accum's `_close`;
  an element whose JAX gradient, read from its Adam first moment, was at
  its tensor's noise floor by the rule of test_torch_step_bars.py);
  and both ranks' weights, u/v, EMA and Adam states bit-equal;
- sharded validation with a metric that fails on rank 1's whole shard:
  both ranks report the same psnr, equal to one process's, and the flaky
  metric averages rank 0's shard only;
- `sum_across_processes` equals the rank-order float64 sum bit for bit;
- the resume decision follows rank 0;
- the train CLI with a SIGTERM on rank 1 at iteration 2: both ranks stop
  there and rank 0 writes 2.state;
- `infer` over two ranks: each chip written by one rank, and the union
  byte-equal to one process's run.
Apart from the ranks: each rank's sampler index stream equals the JAX
sampler's for the same (seed, rank, world).
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from test_torch_step_bars import adam_grads, optax_mu, weights_close
from torch_threads import two_torch_threads  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD, B, K = 2, 2, 2
GAN_LEGS = ("esrgan", "esrgan_accum", "osm")
TIMEOUT = 240
LR, B1 = 1e-4, 0.9  # the small configs' optimizers: lr (the largest) and betas[0]


# -- the ranks -------------------------------------------------------------------


def _state(model):
    """Every tensor a replica holds after a step, on the CPU."""
    out = {"g": model.net_g.state_dict(), "opt_g": model.opt_g.state_dict()["state"]}
    if hasattr(model, "net_d"):
        out.update(d=model.net_d.state_dict(), opt_d=model.opt_d.state_dict()["state"],
                   ema=model.net_g_ema.state_dict())
    else:
        out["ema"] = dict(model.ema)
    return {k: {str(n): (t if isinstance(t, torch.Tensor) else
                         {m: u.clone() for m, u in t.items()}) for n, t in v.items()}
            for k, v in out.items()}


def _step_leg(work, leg, rank):
    from satlas_sr_tpu_torch.models import build_model

    with open(os.path.join(work, f"{leg}.json")) as f:
        opt = json.load(f)
    batch = dict(np.load(os.path.join(work, f"{leg}_r{rank}.npz")))
    if "Chip" in batch:
        batch["Chip"] = [str(c) for c in batch["Chip"]]
    model = build_model(opt, device="cpu")
    if leg == "l2":
        path = os.path.join(work, "l2_masks.pt")
        for _ in range(TIMEOUT * 10):  # written by the test process once its JAX step ran
            if os.path.exists(path):
                break
            time.sleep(0.1)
        model.dropout_masks.replay(torch.load(path))
    logs = {k: float(v) for k, v in model.train_iter(batch, 1).items()}
    torch.save({"logs": logs, "state": _state(model),
                "boxes": getattr(model, "boxes", None)},
               os.path.join(work, f"{leg}_out_r{rank}.pt"))


def _validation_leg(work, rank):
    from satlas_sr_tpu_torch.data import SequentialEvalLoader, build_dataset
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.registry import METRIC_REGISTRY

    @METRIC_REGISTRY.register("calculate_flaky")
    def calculate_flaky(img, img2, **kwargs):  # a tower missing on one host only
        if rank == 1:
            raise RuntimeError("tower weights unavailable on this host")
        return float(np.mean(np.abs(img.astype(np.float64) - img2.astype(np.float64))))

    with open(os.path.join(work, "val.json")) as f:
        plan = json.load(f)
    model = build_model(plan["opt"], device="cpu")
    loader = SequentialEvalLoader(build_dataset(plan["dataset"]), batch_size=1, rank=rank,
                                  world=WORLD)
    local = [int(i) for b in loader for i, v in zip(b["index"], b["valid"]) if v]
    res = model.validation(loader, current_iter=1, dataset_name="val")
    return {"val": res, "val_local": local}


def _collectives_leg(rank):
    from satlas_sr_tpu_torch.parallel import mesh
    from satlas_sr_tpu_torch.train import _broadcast_resume_decision

    vec = np.random.RandomState(rank).randn(7) * 10.0 ** np.arange(-3, 4)
    return {"sum_in": vec.tolist(), "sum_out": mesh.sum_across_processes(vec).tolist(),
            "resume": _broadcast_resume_decision(f"rank{rank}/2.state" if rank == 0 else None),
            "resume_none": _broadcast_resume_decision(None if rank == 0 else "rank1/3.state")}


def _stop_leg(work, rank):
    from satlas_sr_tpu_torch import train as train_cli

    built = []
    real_build = train_cli.build_model

    def build(opt, device):
        model = real_build(opt, device=device)
        step = model.train_iter

        def train_iter(batch, it):
            out = step(batch, it)
            if rank == 1 and it == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        model.train_iter = train_iter
        built.append(model)
        return model

    train_cli.build_model = build
    try:
        train_cli.train_pipeline(work, ["-opt", os.path.join(work, "stop.yml"),
                                        "--launcher", "pytorch"], device="cpu")
    finally:
        train_cli.build_model = real_build
    return {"stopped_at": built[0].step}


def _infer_leg(work, rank):
    import torch.distributed as dist

    from satlas_sr_tpu_torch.infer import run_inference

    with open(os.path.join(work, "infer.json")) as f:
        opt = json.load(f)
    n = run_inference({**opt, "save_path": os.path.join(work, "infer_mp")}, rank=rank,
                      world=WORLD, device="cpu")
    dist.barrier()
    if rank == 0:
        run_inference({**opt, "save_path": os.path.join(work, "infer_one")}, device="cpu")
    return {"infer_written": n}


def worker(rank: int, work: str) -> None:
    """Rank `rank` of the two: every leg, results under `work`."""
    import torch.distributed as dist

    torch.set_num_threads(2)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK="0")
    dist.init_process_group("gloo", init_method=f"file://{work}/init", rank=rank,
                            world_size=WORLD)
    out = {}
    for leg in ("esrgan", "esrgan_accum", "osm", "l2"):
        _step_leg(work, leg, rank)
    out.update(_validation_leg(work, rank))
    out.update(_collectives_leg(rank))
    out.update(_infer_leg(work, rank))
    out.update(_stop_leg(work, rank))  # leaves the process group up: destroy below
    with open(os.path.join(work, f"misc_r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# -- the test process: inputs, the ranks, the JAX references ----------------------


def _rank_rows(rng, leg):
    lr_shape = (4, 32, 32, 3) if leg == "l2" else (32, 32, 6)
    rows = K * B if leg == "esrgan_accum" else B
    return [{"lr": (rng.rand(rows, *lr_shape) * 255).astype(np.uint8),
             "hr": (rng.rand(rows, 128, 128, 3) * 255).astype(np.uint8)} for _ in range(WORLD)]


def _global(leg, parts):
    """The JAX step's global batch: rank order, or with accumulation micro-batch
    j = every rank's micro-batch j in rank order."""
    if leg != "esrgan_accum":
        return {k: np.concatenate([p[k] for p in parts]) for k in ("lr", "hr")}
    return {k: np.concatenate([p[k][j * B:(j + 1) * B] for j in range(K) for p in parts])
            for k in ("lr", "hr")}


def _prepare(work):
    """Configs, per-rank rows, the val tree and the infer tree under `work`."""
    from pathlib import Path

    from test_torch_esrgan_train import small_opt as esrgan_opt
    from test_torch_l2_train import small_opt as l2_opt
    from test_torch_osm_train import OSM, small_opt as osm_opt
    from test_torch_train_cli import make_tree, shipped, write

    rng = np.random.RandomState(12)
    osm_path = os.path.join(work, "osm_chips_to_masks.json")
    with open(osm_path, "w") as f:
        json.dump(OSM, f)
    opts = {"esrgan": esrgan_opt(Path(work)), "esrgan_accum": esrgan_opt(Path(work)),
            "osm": osm_opt(osm_path), "l2": l2_opt("SRCNN")}
    opts["esrgan_accum"]["train"]["accum_steps"] = K
    parts = {}
    for leg, opt in opts.items():
        parts[leg] = _rank_rows(rng, leg)
        if leg == "osm":
            chips = sorted(OSM) + ["703_803"]
            for r, p in enumerate(parts[leg]):
                p["Chip"] = np.asarray(chips[r * B:(r + 1) * B])
        for r, p in enumerate(parts[leg]):
            np.savez(os.path.join(work, f"{leg}_r{r}.npz"), **p)
        with open(os.path.join(work, f"{leg}.json"), "w") as f:
            json.dump({**opt, "world_size": WORLD}, f)

    data = make_tree(Path(work) / "data", np.random.RandomState(3), chips=5)
    val_opt = l2_opt("SRCNN")
    val_opt["network_g"]["revisits"] = 2
    val_opt["val"] = {"metrics": {"psnr": {"type": "calculate_psnr", "crop_border": 4,
                                           "test_y_channel": False},
                                  "flaky": {"type": "calculate_flaky"}}}
    dataset = {"name": "val", "type": "S2NAIPDataset", "phase": "test", "scale": 4,
               "sentinel2_path": str(data / "sentinel2"), "naip_path": str(data / "naip"),
               "n_s2_images": 2, "use_shuffle": False, "use_3d": True}
    with open(os.path.join(work, "val.json"), "w") as f:
        json.dump({"opt": {**val_opt, "world_size": WORLD}, "dataset": dataset}, f)

    stop = shipped("esrgan_s2naip_urban.yml", Path(work), data, total_iter=6)
    stop.update(name="stop", val=None)
    stop["logger"].update(print_freq=1, save_checkpoint_freq=100)
    stop["datasets"]["train"]["batch_size_per_gpu"] = 1
    stop["path"]["experiments_root"] = os.path.join(work, "experiments")
    write(stop, Path(work) / "stop.yml")

    infer = {"data_dir": str(data / "sentinel2"), "n_lr_images": 2, "batch_size": 2,
             "scale": 4, "skip_existing": True, "manual_seed": 5,
             "network_g": {"type": "SSR_RRDBNet", "num_in_ch": 6, "num_out_ch": 3,
                           "num_feat": 8, "num_block": 1, "num_grow_ch": 4}}
    with open(os.path.join(work, "infer.json"), "w") as f:
        json.dump(infer, f)
    return opts, parts


def _jax_references(work, opts, parts):
    """{leg: (JAX logs, JAX states in the port's names)} of the one-process
    step on each leg's global batch; writes the L2 step's masks first."""
    from unittest import mock

    import jax
    from jax.sharding import Mesh

    import satlas_sr_tpu.models.base as jax_base
    from satlas_sr_tpu.models import build_model as jax_build_model
    from satlas_sr_tpu.utils import torch_io as jax_torch_io
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.utils.torch_io import (osm_disc_from_jax, osm_disc_to_reference,
                                                    rrdbnet_from_jax, srcnn_from_jax,
                                                    unet_disc_from_jax)
    from test_torch_l2_train import RecordedDropout
    from test_torch_osm_train import flax_init_from

    def numpy(state):
        return {k: v.numpy() for k, v in state.items()}

    out = {}
    one_device = mock.patch.object(jax_base, "data_mesh",
                                   lambda: Mesh(np.array(jax.devices()[:1]), ("data",)))
    with one_device:
        opt = opts["l2"]
        pm = build_model(json.loads(json.dumps(opt)), device="cpu")
        with flax_init_from({"SRCNN": jax_torch_io.srcnn_from_torch(
                numpy(pm.net_g.state_dict()), residual_layers=1)}):
            jm = jax_build_model(json.loads(json.dumps(opt)))
        with RecordedDropout() as dropout:
            logs = jm.train_iter(_global("l2", parts["l2"]), 1)
            jax.effects_barrier()
        torch.save(dropout.in_order(), os.path.join(work, "l2_masks.pt.tmp"))
        os.replace(os.path.join(work, "l2_masks.pt.tmp"), os.path.join(work, "l2_masks.pt"))
        host = jax.device_get(jm.state)
        out["l2"] = (logs, {"g": srcnn_from_jax({"params": host["params"]}),
                            "ema": srcnn_from_jax({"params": host["ema"]})}, {})

        for leg in GAN_LEGS:
            opt = opts[leg]
            pm = build_model(json.loads(json.dumps(opt)), device="cpu")
            if leg == "osm":
                d_cls, d_from = "OSMObjDiscriminator", osm_disc_from_jax
                d_init = jax_torch_io.osm_disc_from_torch(
                    numpy(osm_disc_to_reference(pm.net_d.state_dict())))
            else:
                d_cls, d_from = "UNetDiscriminatorSN", unet_disc_from_jax
                d_init = jax_torch_io.unet_disc_from_torch(numpy(pm.net_d.state_dict()))
            with flax_init_from({"RRDBNet": jax_torch_io.rrdbnet_from_torch(
                    numpy(pm.net_g.state_dict()), num_block=1), d_cls: d_init}):
                jm = jax_build_model(json.loads(json.dumps(opt)))
            batch = _global(leg, parts[leg])
            if leg == "osm":  # each JAX process draws its own chips' boxes
                batch["Chip"] = [str(c) for p in parts[leg] for c in p["Chip"]]
                draw = jm._sample_boxes
                seed = (int(opt["manual_seed"]) * 7919 + 1) % (2 ** 31 - 1)
                boxes = np.concatenate([draw([str(c) for c in p["Chip"]],
                                             np.random.RandomState(seed)) for p in parts[leg]])
                jm._sample_boxes = lambda chips, rng: boxes
            logs = jm.train_iter(batch, 1)
            host = jax.device_get(jm.state)
            # the step's gradients, from Adam's first moment (test_torch_step_bars.adam_grads)
            mu = {"g": rrdbnet_from_jax({"params": optax_mu(host["g"]["opt"])}),
                  "d": d_from({"params": optax_mu(host["d"]["opt"])})}
            out[leg] = (logs, {"g": rrdbnet_from_jax({"params": host["g"]["params"]}),
                               "d": d_from(host["d"]),
                               "ema": rrdbnet_from_jax({"params": host["ema"]})},
                        {part: adam_grads([m], B1) for part, m in mu.items()})
    return {leg: ({k: float(v) for k, v in jax.device_get(logs).items()}, states, grads)
            for leg, (logs, states, grads) in out.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("torch_mp"))
    opts, parts = _prepare(work)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [HERE, ROOT, os.environ.get("PYTHONPATH", "")])}
    code = "import sys, test_torch_multiprocess as t; t.worker(int(sys.argv[1]), sys.argv[2])"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), work], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        jax_ref = _jax_references(work, opts, parts)
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:  # a hung or failed rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(work, f"misc_r{r}.json")) as f:
            misc = json.load(f)
        misc.update({leg: torch.load(os.path.join(work, f"{leg}_out_r{r}.pt"),
                                     weights_only=False) for leg in ("l2",) + GAN_LEGS})
        ranks.append(misc)
    return {"work": work, "ranks": ranks, "jax": jax_ref, "opts": opts}


def _close(got, want, what, grads=None):
    """test_torch_accum's bar, with the noise-floor rule of
    test_torch_step_bars.py for an element whose JAX gradient was at its
    tensor's noise floor (`grads`: JAX's gradients of the step)."""
    weights_close(got, want, lambda ref: 1e-4 * ref.abs().max() + 1e-6, what, grads, LR)


@pytest.mark.parametrize("leg", ["l2", "esrgan", "esrgan_accum", "osm"])
def test_two_rank_step_matches_jax_on_the_global_batch(run, leg):
    want_logs, want, grads = run["jax"][leg]
    for r, rank in enumerate(run["ranks"]):
        got = rank[leg]
        assert sorted(got["logs"]) == sorted(want_logs), (r, sorted(got["logs"]))
        for k, v in want_logs.items():
            assert abs(got["logs"][k] - v) <= 1e-4 * abs(v) + 1e-7, (leg, r, k, got["logs"][k], v)
        for part, tensors in want.items():
            _close(got["state"][part], tensors, (leg, r, part), grads.get(part))
    if leg != "l2":
        assert any(n.endswith("weight_u") for n in want["d"])


@pytest.mark.parametrize("leg", ["l2", "esrgan", "esrgan_accum", "osm"])
def test_replicas_bit_equal_after_the_step(run, leg):
    a, b = (rank[leg] for rank in run["ranks"])
    assert a["logs"] == b["logs"]
    for part in a["state"]:
        for name, t in a["state"][part].items():
            other = b["state"][part][name]
            if isinstance(t, dict):  # an Adam state: exp_avg, exp_avg_sq, step
                assert all(torch.equal(t[m], other[m]) for m in t), (leg, part, name)
            else:
                assert torch.equal(t, other), (leg, part, name)


def test_osm_ranks_draw_their_own_chips_boxes(run):
    from satlas_sr_tpu_torch.models.osm_esrgan import OSMObjESRGANModel

    seed = (int(run["opts"]["osm"]["manual_seed"]) * 7919 + 1) % (2 ** 31 - 1)
    model = OSMObjESRGANModel.__new__(OSMObjESRGANModel)
    model.n_osm_objs = run["opts"]["osm"]["n_osm_objs"]
    with open(run["opts"]["osm"]["datasets"]["train"]["osm_objs_path"]) as f:
        model.osm_obj_data = json.load(f)
    for r, rank in enumerate(run["ranks"]):
        chips = [str(c) for c in np.load(os.path.join(run["work"], f"osm_r{r}.npz"))["Chip"]]
        want = model._sample_boxes(chips, np.random.RandomState(seed))
        np.testing.assert_array_equal(rank["osm"]["boxes"], want)


def test_sharded_validation_with_a_rank_local_metric_failure(run):
    from satlas_sr_tpu_torch.data import SequentialEvalLoader, build_dataset
    from satlas_sr_tpu_torch.models import build_model

    with open(os.path.join(run["work"], "val.json")) as f:
        plan = json.load(f)
    r0, r1 = run["ranks"]
    assert r0["val"] == r1["val"]
    assert sorted(r0["val_local"] + r1["val_local"]) == list(range(5))
    assert not set(r0["val_local"]) & set(r1["val_local"])
    opt = {**plan["opt"], "world_size": 1}
    opt["val"] = {"metrics": {"psnr": opt["val"]["metrics"]["psnr"]}}
    model = build_model(opt, device="cpu")
    ds = build_dataset(plan["dataset"])
    one = model.validation(SequentialEvalLoader(ds, batch_size=1), 1, dataset_name="val")
    assert abs(r0["val"]["psnr"] - one["psnr"]) <= 1e-9 * abs(one["psnr"])
    # the flaky metric: rank 0's chips only, a per-pixel MAE, not diluted by rank 1's
    outs = {int(b["index"][0]): model.eval_outputs(b).numpy()[0]
            for b in SequentialEvalLoader(ds, batch_size=1)}
    mae = [np.mean(np.abs(outs[i].astype(np.float64) - ds[i]["hr"].astype(np.float64)))
           for i in r0["val_local"]]
    assert abs(r0["val"]["flaky"] - np.mean(mae)) <= 1e-9 * np.mean(mae)


def test_sum_across_processes_is_the_rank_order_float64_sum(run):
    rows = [np.asarray(rank["sum_in"], np.float64) for rank in run["ranks"]]
    want = rows[0] + rows[1]
    for rank in run["ranks"]:
        got = np.asarray(rank["sum_out"], np.float64)
        assert got.tobytes() == want.tobytes()


def test_resume_decision_follows_rank_0(run):
    for rank in run["ranks"]:
        assert rank["resume"] == "rank0/2.state"
        assert rank["resume_none"] is None


def test_stop_on_one_rank_stops_both_at_the_same_iteration(run):
    assert [rank["stopped_at"] for rank in run["ranks"]] == [2, 2]
    states = os.path.join(run["work"], "experiments", "stop", "training_states")
    assert sorted(os.listdir(states)) == ["2.state"]


def test_infer_over_two_ranks_equals_one_process(run):
    mp, one = (os.path.join(run["work"], d) for d in ("infer_mp", "infer_one"))
    files = sorted(os.path.relpath(p, one) for p in glob.glob(os.path.join(one, "**", "*.png"),
                                                               recursive=True))
    assert len(files) == 10  # five chips: sr.png and lr.png each
    assert files == sorted(os.path.relpath(p, mp) for p in
                           glob.glob(os.path.join(mp, "**", "*.png"), recursive=True))
    for rel in files:
        with open(os.path.join(mp, rel), "rb") as a, open(os.path.join(one, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert [rank["infer_written"] for rank in run["ranks"]] == [3, 2]
    assert os.path.exists(os.path.join(mp, ".ssr_corpus_manifest.json"))


@pytest.mark.parametrize("kind", ["weighted", "shuffled", "ordered"])
@pytest.mark.parametrize("world", [2, 3])
def test_per_rank_sampler_streams_match_jax(kind, world):
    """Each rank's index stream (from the start and fast-forwarded) equals
    the JAX sampler's for the same (seed, rank, world); the ranks' streams
    of one epoch of the shuffled sampler partition it."""
    from itertools import islice

    from satlas_sr_tpu.data import sampler as jax_sampler
    from satlas_sr_tpu_torch.data import sampler

    def make(mod, seed, rank):
        if kind == "weighted":
            w = np.random.RandomState(0).rand(13) + 0.1
            return mod.WeightedInfiniteSampler(w, seed, rank, world, chunk=50)
        return mod.EnlargedShuffleSampler(13, seed, rank, world, ratio=2,
                                          shuffle=kind == "shuffled")

    epochs = []
    for rank in range(world):
        for start in (0, 7, 40):
            got = list(islice(make(sampler, 5 + rank, rank).iter_from(start), 30))
            want = list(islice(make(jax_sampler, 5 + rank, rank).iter_from(start), 30))
            assert got == want, (rank, start)
        if kind != "weighted":  # one epoch of each rank from one seed
            epochs.append(make(sampler, 5, rank).epoch_indices(0).tolist())
    if epochs:
        assert sorted(sum(epochs, [])) == sorted(list(range(13)) * 2)

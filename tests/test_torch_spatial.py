"""The port's 'space' row sharding on the inference path (parallel/mesh.mesh_2d,
parallel/halo.py, the band forwards, InferenceEngine(spatial_shards=),
whole-tile infer_grid) in four gloo processes on the CPU, against the port's
unsharded forward and the JAX package, computed here.

One module fixture starts four ranks once (torch.distributed, gloo,
init_method file:// under the fixture's tmp dir; each rank with its own
deadline) and runs every leg at small width in float32, on two layouts: S = 4
(the two middle ranks are interior bands with halos on both sides) and
dp 2 x sp 2. Each rank writes its results to disk. Meanwhile this process
computes the JAX references on the same seeded numpy inputs and the port's
seeded weights (a reference .pth that both packages load, or the port's
`rrdbnet_to_jax`). The legs:
(a) exchange_rows and gather_rows: exact rows, none beyond the image's
    border, NHWC and NCHW;
(b) RRDBNet.forward_band at scales 4, 2 and 1 against the port's unsharded
    forward (max|d| <= 1e-5 max|y|) and against JAX's row-sharded forward
    (tests/test_spatial.py's mesh_2d on the conftest CPU mesh) at
    test_torch_rrdbnet's tolerance, atol/rtol 1e-4; SRCNN and HighResNet
    band forwards (3x3 reflect convs at both widths, a reference frame, a
    mask, a size-changing resize) against their unsharded forwards;
(c) InferenceEngine(spatial_shards=4).run and run_band against the
    unsharded engine: uint8 within 1 level on <= 0.1% of values (whether
    bit-equal is printed); rows that do not split run whole;
(d) whole-tile infer_grid, SSR_RRDBNet and SRCNN, on two tiles, under S = 4
    and dp 2 x sp 2, against JAX's run_whole_tile: stitched_sr.png within 1
    level on <= 0.1%, stitched_s2.png byte-equal, each file written by one
    rank (space index 0 of the tile's data group);
(e) the refusals: spatial_shards 2 without a launcher; a space group that
    would span hosts (LOCAL_WORLD_SIZE below S) on every rank;
(f) the three trainer families through the train CLI at spatial_shards 2
    (dp 2 x sp 2): one iteration, checkpoint and validation on bands
    (tests/test_torch_spatial_train.py holds the step against JAX).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD, TIMEOUT = 4, 180
NF, G = 8, 4
N_FRAMES, GRID = 2, 4  # whole tile: 128 x 128 LR rows, 32 a band at S = 4
X_SHAPE = (2, 96, 64, 6)  # scale 1 needs 5 x 4 rows a band: 96 / 4 = 24
SRCNN_NET = dict(type="SRCNN", in_channels=3, mask_channels=0, hidden_channels=16, out_channels=3,
                 kernel_size=3, residual_layers=1, output_size=128, zoom_factor=4,
                 sr_kernel_size=1)
RRDB_NET = dict(type="SSR_RRDBNet", num_in_ch=N_FRAMES * 3, num_out_ch=3, num_feat=NF,
                num_block=1, num_grow_ch=G)
LAYOUTS = {"sp4": 4, "dp2sp2": 2}
TRAIN_FAMILIES = {"esrgan": "esrgan_s2naip_urban.yml", "l2": "srcnn_s2naip_urban.yml",
                  "osm": "osm_obj_esrgan.yml"}


def _rrdb(scale, seed=0):
    """The port's seeded RRDBNet with non-zero biases, so every bias is wired,
    and its dense-block convs at Kaiming scale (x10 the init's 0.1), so that
    a conv's branch is as large as its input and a halo row short of the
    five an RDB needs shows far above the bar."""
    from satlas_sr_tpu_torch.archs import RRDBNet

    m = RRDBNet(num_in_ch=6, num_out_ch=3, scale=scale, num_feat=NF, num_block=2, num_grow_ch=G,
                seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
            elif name.startswith("body."):
                p.mul_(10.0)
    return m.eval()


def _revisit_models():
    """SRCNN and HighResNet at small width, their widest band paths on."""
    from satlas_sr_tpu_torch.archs.highresnet import HighResNet
    from satlas_sr_tpu_torch.archs.srcnn import SRCNN

    common = dict(in_channels=3, revisits=3, hidden_channels=16, out_channels=3, kernel_size=3,
                  sr_kernel_size=3, device="cpu")
    return {"srcnn": SRCNN(mask_channels=1, use_reference_frame=True, output_size=96, **common),
            "highresnet": HighResNet(output_size=64, seed=1, **common)}


# -- the ranks -------------------------------------------------------------------


def _halo_leg(sp4, sp2):
    from satlas_sr_tpu_torch.parallel.halo import exchange_rows, gather_rows

    full = torch.arange(2 * 16 * 3 * 5, dtype=torch.float32).reshape(2, 16, 3, 5)
    out = {}
    for name, space in (("sp4", sp4), ("sp2", sp2)):
        r0, r1 = space.band(16)
        ext, top, bottom = exchange_rows(full[:, r0:r1], 2, space)
        nchw, t2, b2 = exchange_rows(full.permute(0, 3, 1, 2)[:, :, r0:r1], 2, space, dim=2)
        out[name] = {"ext": ext.numpy(), "top": top, "bottom": bottom,
                     "nchw": nchw.permute(0, 2, 3, 1).numpy(), "nchw_tb": [t2, b2],
                     "gathered": gather_rows(full[:, r0:r1], space).numpy(),
                     "u8": gather_rows(full[:, r0:r1].to(torch.uint8), space).numpy()}
    return out


def _band_leg(work, sp4):
    x = torch.from_numpy(np.load(os.path.join(work, "x.npy")))
    r0, r1 = sp4.band(x.shape[1])
    out = {}
    with torch.no_grad():
        for scale in (4, 2, 1):
            m = _rrdb(scale)
            out[f"rrdb{scale}"] = m.forward_band(x[:, r0:r1], sp4).numpy()
            if sp4.space_index == 0:
                out[f"rrdb{scale}_whole"] = m(x).numpy()
        x5 = torch.from_numpy(np.load(os.path.join(work, "x5.npy")))
        mask = torch.from_numpy(np.load(os.path.join(work, "mask.npy")))
        for name, m in _revisit_models().items():
            m.eval()
            args = (mask[:, :, r0:r1],) if name == "srcnn" else ()
            out[name] = m.forward_band(x5[:, :, r0:r1], sp4, *args).numpy()
            if sp4.space_index == 0:
                out[f"{name}_whole"] = m(x5, *((mask,) if name == "srcnn" else ())).numpy()
    return out


def _engine_leg(work, sp4):
    from satlas_sr_tpu_torch.inference import InferenceEngine

    x = np.load(os.path.join(work, "u8.npy"))
    model = _rrdb(4)
    eng = InferenceEngine(model, batch_size=4, device="cpu", spatial_shards=4)
    r0, r1 = eng.band_rows(x.shape[1])
    out = {"run": eng.run(x), "band": eng.run_band(x[:, r0:r1]), "rows": [r0, r1],
           "odd": eng.run(x[:, :30]), "odd_band": eng.band_rows(30)}
    if sp4.space_index == 0:
        plain = InferenceEngine(_rrdb(4), batch_size=4, device="cpu")
        out.update(plain=plain.run(x), plain_odd=plain.run(x[:, :30]))
    return out


def _grid_leg(work, rank):
    from satlas_sr_tpu_torch import infer_grid

    with open(os.path.join(work, "grid.json")) as f:
        plans = json.load(f)
    written = {}
    real_write = infer_grid.write_png

    def write(path, img):
        written.setdefault(os.path.relpath(path, work), []).append(rank)
        return real_write(path, img)

    infer_grid.write_png = write
    try:
        counts = {}
        for net in ("rrdb", "srcnn"):
            for layout, sp in LAYOUTS.items():
                opt = {**plans[net], "spatial_shards": sp,
                       "save_path": os.path.join(work, f"port_{net}_{layout}")}
                counts[f"{net}_{layout}"] = infer_grid.run_grid(opt, rank, WORLD, device="cpu")
    finally:
        infer_grid.write_png = real_write
    return {"written": written, "counts": counts}


def _refusal_leg(work, rank):
    from satlas_sr_tpu_torch import infer_grid
    from satlas_sr_tpu_torch.parallel import mesh

    with open(os.path.join(work, "grid.json")) as f:
        plans = json.load(f)
    out = []
    for local, sp in (("1", 2), ("2", 4)):
        os.environ["LOCAL_WORLD_SIZE"] = local
        try:
            for fn in (lambda: mesh.mesh_2d(sp),
                       lambda: infer_grid.run_grid({**plans["rrdb"], "spatial_shards": sp,
                                                    "save_path": os.path.join(work, "refused")},
                                                   rank, WORLD, device="cpu")):
                try:
                    fn()
                    out.append(None)
                except ValueError as e:
                    out.append(str(e))
        finally:
            os.environ["LOCAL_WORLD_SIZE"] = str(WORLD)
    return out


def _train_leg(work, rank):
    """Each trainer family through the train CLI at spatial_shards 2 (dp 2 x
    sp 2): one iteration, the checkpoint and validation on bands."""
    from satlas_sr_tpu_torch import train as train_cli

    built = []
    real_build = train_cli.build_model

    def build(opt, device):
        built.append(real_build(opt, device=device))
        return built[-1]

    train_cli.build_model = build
    out = {}
    try:
        for family in TRAIN_FAMILIES:
            train_cli.train_pipeline(work, ["-opt", os.path.join(work, f"{family}.yml"),
                                            "--launcher", "pytorch"], device="cpu")
            model = built[-1]
            out[family] = {"layout": tuple(model.space[:4]),
                           "logs": {k: float(v) for k, v in model.log_dict.items()},
                           "g": {k: v.clone() for k, v in model.net_g.state_dict().items()}}
    finally:
        train_cli.build_model = real_build
    return out


def worker(rank: int, work: str) -> None:
    """Rank `rank` of the four: every leg, results under `work`."""
    import pickle

    import torch.distributed as dist

    from satlas_sr_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(WORLD))
    dist.init_process_group("gloo", init_method=f"file://{work}/init", rank=rank,
                            world_size=WORLD)
    sp4, sp2 = mesh.mesh_2d(4), mesh.mesh_2d(2)
    out = {"layouts": [tuple(sp4[:4]), tuple(sp2[:4]), sp4.ranks, sp2.ranks],
           "axis": [mesh.mesh_axis_size(sp2, "data"), mesh.mesh_axis_size(sp2, "space")]}
    out["halo"] = _halo_leg(sp4, sp2)
    out["band"] = _band_leg(work, sp4)
    out["engine"] = _engine_leg(work, sp4)
    out["grid"] = _grid_leg(work, rank)
    out["refused"] = _refusal_leg(work, rank)
    out["train"] = _train_leg(work, rank)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# -- the test process: inputs, the ranks, the JAX references ----------------------


def _write_tiles(data_dir):
    from satlas_sr_tpu_torch.utils.imgio import write_png

    rng = np.random.RandomState(7)
    for tile in ("tile_a", "tile_b"):
        for i in range(GRID):
            for j in range(GRID):
                png = (rng.rand(3 * 32, 32, 3) * 254 + 1).astype(np.uint8)
                if (i + j) % 5 == 0:
                    png[32:40] = 0  # a black frame: the good-first policy skips it
                write_png(os.path.join(data_dir, tile, f"{i}_{j}.png"), png)


def _prepare(work):
    from satlas_sr_tpu_torch.archs.srcnn import SRCNN
    from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict

    rng = np.random.RandomState(3)
    np.save(os.path.join(work, "x.npy"), rng.rand(*X_SHAPE).astype(np.float32))
    np.save(os.path.join(work, "x5.npy"), rng.rand(1, 3, 96, 40, 3).astype(np.float32))
    np.save(os.path.join(work, "mask.npy"), rng.randint(0, 12, (1, 3, 96, 40, 1)).astype(np.int64))
    np.save(os.path.join(work, "u8.npy"), rng.randint(0, 256, (3, 64, 48, 6)).astype(np.uint8))
    data = os.path.join(work, "data")
    _write_tiles(data)
    weights = {"rrdb": os.path.join(work, "rrdb.pth"), "srcnn": os.path.join(work, "srcnn.pth")}
    from satlas_sr_tpu_torch.archs import RRDBNet

    save_torch_state_dict(weights["rrdb"], RRDBNet(num_in_ch=6, num_out_ch=3, num_feat=NF,
                                                   num_block=1, num_grow_ch=G, seed=5,
                                                   device="cpu").state_dict(), "params_ema")
    net = {k: v for k, v in SRCNN_NET.items() if k != "type"}
    save_torch_state_dict(weights["srcnn"], SRCNN(revisits=N_FRAMES, seed=6, device="cpu",
                                                  **net).state_dict(), "params_ema")
    plans = {}
    for name, netg in (("rrdb", RRDB_NET), ("srcnn", SRCNN_NET)):
        plans[name] = {"data_dir": data, "n_lr_images": N_FRAMES, "scale": 4, "grid_size": GRID,
                       "batch_size": 1, "whole_tile": True, "manual_seed": 4,
                       "compute_dtype": "float32", "matmul_precision": "highest",
                       "network_g": netg,
                       "path": {"pretrain_network_g": weights[name], "param_key_g": "params_ema"}}
    with open(os.path.join(work, "grid.json"), "w") as f:
        json.dump(plans, f)
    _write_train_ymls(work)
    return plans


def _write_train_ymls(work):
    """The three families' shipped configs at small width at spatial_shards 2
    on a synthetic tree, one iteration and a validation each."""
    from pathlib import Path

    from test_torch_train_cli import make_tree, shipped, write

    data = make_tree(Path(work) / "train_data", np.random.RandomState(9), chips=4)
    for family, config in TRAIN_FAMILIES.items():
        opt = shipped(config, Path(work), data, total_iter=1)
        opt.update(name=f"sp2_{family}", spatial_shards=2)
        opt["val"] = {"val_freq": 1, "save_img": False,
                      "metrics": {"psnr": {"type": "calculate_psnr", "crop_border": 4,
                                           "test_y_channel": False}}}
        opt["logger"].update(print_freq=1, save_checkpoint_freq=100)
        opt["datasets"]["train"]["batch_size_per_gpu"] = 1
        opt["path"]["experiments_root"] = os.path.join(work, "experiments", family)
        write(opt, Path(work) / f"{family}.yml")


def _jax_references(work, plans):
    """JAX's row-sharded RRDBNet forward at each scale and its whole-tile runs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from satlas_sr_tpu.archs import RRDBNet as JaxRRDBNet
    from satlas_sr_tpu.infer_grid import run_whole_tile
    from satlas_sr_tpu.parallel.mesh import mesh_2d, spatial_sharding
    from satlas_sr_tpu_torch.utils.torch_io import rrdbnet_to_jax

    x = np.load(os.path.join(work, "x.npy"))
    mesh = mesh_2d(4)
    out = {}
    for scale in (4, 2, 1):
        model = JaxRRDBNet(num_in_ch=6, num_out_ch=3, scale=scale, num_feat=NF, num_block=2,
                           num_grow_ch=G, dtype=jnp.float32)
        variables = rrdbnet_to_jax(_rrdb(scale).state_dict())
        in_s = spatial_sharding(mesh, 4)
        rep = jax.device_put(variables, NamedSharding(mesh, P()))
        with jax.default_matmul_precision("highest"):
            y = jax.jit(model.apply, out_shardings=in_s)(rep, jax.device_put(x, in_s))
        out[f"rrdb{scale}"] = np.asarray(y)
    for name, plan in plans.items():
        assert run_whole_tile({**plan, "spatial_shards": 1,
                               "save_path": os.path.join(work, f"jax_{name}")}) == 2
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import pickle

    work = str(tmp_path_factory.mktemp("torch_spatial"))
    plans = _prepare(work)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [HERE, ROOT, os.environ.get("PYTHONPATH", "")])}
    code = "import sys, test_torch_spatial as t; t.worker(int(sys.argv[1]), sys.argv[2])"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), work], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        jax_ref = _jax_references(work, plans)
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
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"work": work, "ranks": ranks, "jax": jax_ref}


def test_layouts(run):
    for r, rank in enumerate(run["ranks"]):
        sp4, sp2, ranks4, ranks2 = rank["layouts"]
        assert sp4 == (r, 4, 0, 1) and ranks4 == (0, 1, 2, 3)
        assert sp2 == (r % 2, 2, r // 2, 2) and ranks2 == (r // 2 * 2, r // 2 * 2 + 1)
        assert rank["axis"] == [2, 2]


@pytest.mark.parametrize("layout", ["sp4", "sp2"])
def test_exchange_and_gather_rows_are_exact(run, layout):
    full = np.arange(2 * 16 * 3 * 5, dtype=np.float32).reshape(2, 16, 3, 5)
    s = 4 if layout == "sp4" else 2
    step = 16 // s
    for r, rank in enumerate(run["ranks"]):
        got = rank["halo"][layout]
        i = r % s
        top, bottom = (2 if i > 0 else 0), (2 if i < s - 1 else 0)
        assert (got["top"], got["bottom"]) == (top, bottom)
        assert got["nchw_tb"] == [top, bottom]
        want = full[:, i * step - top:(i + 1) * step + bottom]
        np.testing.assert_array_equal(got["ext"], want)
        np.testing.assert_array_equal(got["nchw"], want)
        np.testing.assert_array_equal(got["gathered"], full)
        np.testing.assert_array_equal(got["u8"], full.astype(np.uint8))


@pytest.mark.parametrize("scale", [4, 2, 1])
def test_rrdbnet_band_forward_matches_whole_and_jax(run, scale):
    got = np.concatenate([rank["band"][f"rrdb{scale}"] for rank in run["ranks"]], axis=1)
    whole = run["ranks"][0]["band"][f"rrdb{scale}_whole"]
    assert got.shape == whole.shape == (X_SHAPE[0], X_SHAPE[1] * scale, X_SHAPE[2] * scale, 3)
    err = np.abs(got - whole).max()
    print(f"scale {scale}: band forward against the unsharded forward, max|d| {err:.3e} "
          f"(max|y| {np.abs(whole).max():.3f})")
    assert err <= 1e-5 * np.abs(whole).max()
    np.testing.assert_allclose(got, run["jax"][f"rrdb{scale}"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["srcnn", "highresnet"])
def test_revisit_band_forwards_match_whole(run, name):
    got = np.concatenate([rank["band"][name] for rank in run["ranks"]], axis=2)
    whole = run["ranks"][0]["band"][f"{name}_whole"]
    assert got.shape == whole.shape
    assert np.abs(got - whole).max() <= 1e-5 * np.abs(whole).max()


def test_engine_spatial_matches_unsharded(run):
    r0 = run["ranks"][0]["engine"]
    plain = r0["plain"]
    for r, rank in enumerate(run["ranks"]):
        e = rank["engine"]
        assert e["rows"] == [16 * r, 16 * (r + 1)]
        assert e["run"].shape == plain.shape == (3, 256, 192, 3)
        d = np.abs(e["run"].astype(int) - plain.astype(int))
        print(f"rank {r}: sharded engine bit-equal to the unsharded one: {not d.any()}")
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        np.testing.assert_array_equal(e["band"], e["run"][:, 64 * r:64 * (r + 1)])
        assert e["odd_band"] is None  # 30 rows do not make 4 bands: whole on every rank
        np.testing.assert_array_equal(e["odd"], r0["plain_odd"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("net", ["rrdb", "srcnn"])
def test_whole_tile_matches_jax(run, net, layout):
    from satlas_sr_tpu_torch.utils.imgio import read_png

    work, s = run["work"], LAYOUTS[layout]
    port, ref = os.path.join(work, f"port_{net}_{layout}"), os.path.join(work, f"jax_{net}")
    for tile in ("tile_a", "tile_b"):
        sr = read_png(os.path.join(port, tile, "stitched_sr.png"))
        want = read_png(os.path.join(ref, tile, "stitched_sr.png"))
        assert sr.shape == want.shape == (GRID * 128, GRID * 128, 3)
        d = np.abs(sr.astype(int) - want.astype(int))
        print(f"{net} {layout} {tile}: bit-equal to JAX {not d.any()}")
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        np.testing.assert_array_equal(read_png(os.path.join(port, tile, "stitched_s2.png")),
                                      read_png(os.path.join(ref, tile, "stitched_s2.png")))
    writers = {}
    for rank in run["ranks"]:
        for path, who in rank["grid"]["written"].items():
            if path.startswith(f"port_{net}_{layout}{os.sep}"):
                writers.setdefault(path, []).extend(who)
    # each file once; space index 0 of the group that owns the tile
    owner = {"tile_a": 0, "tile_b": 0 if s == 4 else 2}
    assert len(writers) == 4
    for path, who in writers.items():
        assert who == [owner[path.split(os.sep)[1]]], (path, who)
    counts = [rank["grid"]["counts"][f"{net}_{layout}"] for rank in run["ranks"]]
    assert counts == ([2] * 4 if s == 4 else [1] * 4)


def test_space_group_spanning_hosts_is_refused_on_every_rank(run):
    for rank in run["ranks"]:
        assert len(rank["refused"]) == 4
        for msg in rank["refused"]:
            assert msg is not None and "spatial sharding" in msg, msg


def test_spatial_shards_without_a_launcher_is_refused(tmp_path):
    from satlas_sr_tpu_torch import infer_grid
    from satlas_sr_tpu_torch.inference import InferenceEngine

    opt = {"data_dir": str(tmp_path), "save_path": str(tmp_path / "o"), "n_lr_images": N_FRAMES,
           "scale": 4, "whole_tile": True, "spatial_shards": 2, "network_g": RRDB_NET}
    with pytest.raises(ValueError, match="must divide the process count 1"):
        infer_grid.run_grid(opt, device="cpu")
    with pytest.raises(ValueError, match="--launcher"):
        InferenceEngine(_rrdb(4), device="cpu", spatial_shards=2)
    assert infer_grid.default_spatial_shards(512) == 1


@pytest.mark.parametrize("family", ["esrgan", "l2", "osm"])
def test_trainers_refuse_spatial_shards(run, tmp_path, family):
    """Each trainer family refuses a configured row split it cannot run (one
    process, no launcher) instead of dropping it, and trains on the four
    ranks at spatial_shards 2 through the train CLI: dp 2 x sp 2, one
    iteration, the same finite logs and generator on every rank, one
    checkpoint (rank 0's) and a validation on bands."""
    from satlas_sr_tpu_torch.models import build_model

    if family == "esrgan":
        from test_torch_esrgan_train import small_opt
        opt = small_opt(tmp_path)
    elif family == "l2":
        from test_torch_l2_train import small_opt
        opt = small_opt("SRCNN")
    else:
        from test_torch_osm_train import OSM, small_opt
        (tmp_path / "osm.json").write_text(json.dumps(OSM))
        opt = small_opt(str(tmp_path / "osm.json"))
    with pytest.raises(ValueError, match="must divide the process count 1: start S ranks"):
        build_model({**opt, "spatial_shards": 2}, device="cpu")
    assert type(build_model({**opt, "spatial_shards": 1}, device="cpu")).__name__.startswith(
        {"esrgan": "ESRGAN", "l2": "L2", "osm": "OSMObj"}[family])
    got = [rank["train"][family] for rank in run["ranks"]]
    assert [g["layout"] for g in got] == [(r % 2, 2, r // 2, 2) for r in range(WORLD)]
    assert got[0]["logs"] and all(np.isfinite(v) for v in got[0]["logs"].values())
    for g in got[1:]:
        assert g["logs"] == got[0]["logs"]
        assert all(torch.equal(g["g"][k], v) for k, v in got[0]["g"].items())
    exp = os.path.join(run["work"], "experiments", family, f"sp2_{family}")
    assert sorted(f for f in os.listdir(os.path.join(exp, "models"))
                  if f.endswith(".pth")) == (["net_d_latest.pth"] if family != "l2" else []) + [
        "net_g_latest.pth"]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if "val_dataset" in line]
    assert len(rows) == 2 and all(np.isfinite(r["psnr"]) for r in rows)  # at iter 1, and final


@pytest.mark.parametrize("env, rows, want", [
    ({"LOCAL_WORLD_SIZE": "4"}, 512, 4),
    ({"LOCAL_WORLD_SIZE": "8"}, 96, 8),
    ({"LOCAL_WORLD_SIZE": "8"}, 100, 4),
    ({"SLURM_TASKS_PER_NODE": "6(x2),3"}, 512, 2),
    ({"SLURM_NTASKS_PER_NODE": "2"}, 512, 2),
    ({}, 512, 1),
])
def test_default_spatial_shards_reads_the_ranks_on_this_host(monkeypatch, env, rows, want):
    """The whole-tile default split: the largest power of 2 dividing both the
    ranks on this host (torchrun's LOCAL_WORLD_SIZE, else SLURM's tasks per
    node, else 1 without a launcher) and the rows (JAX: its local devices)."""
    from satlas_sr_tpu_torch import infer_grid

    for key in ("LOCAL_WORLD_SIZE", "SLURM_TASKS_PER_NODE", "SLURM_NTASKS_PER_NODE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert infer_grid.default_spatial_shards(rows) == want
    assert infer_grid.whole_tile_shards({"spatial_shards": 0}) == \
        infer_grid.default_spatial_shards(16 * 32)
    assert infer_grid.whole_tile_shards({"spatial_shards": 2}) == 2

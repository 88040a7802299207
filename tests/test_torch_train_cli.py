"""The port's train CLI (satlas_sr_tpu_torch.train) on the CPU, end to end.

- Two iterations with a checkpoint, then --auto_resume to three, give the
  same weights, EMA, discriminator (u/v included) and losses, bit for bit,
  as a straight three-iteration run: the loader fast-forwards, and the
  .state carries the Adam states, the update counts and the spectral
  buffers.
- The JAX package's `load_network_variables` reads the port's
  net_g_latest.pth, and its eval forward equals the port's (atol 1e-5);
  beside each .pth the port writes the JAX layout's .msgpack, which the
  JAX package's `load_pytree` reads.
- Auto-resume skips a torn .state; `checkpoint_backend: orbax` trains
  (torch.distributed.checkpoint steps, no .state);
  device="cuda" without a card raises before anything is written.
- The ten shipped train configs (esrgan_s2naip_urban, esrgan_s2naip_full,
  rand_crop_, allbands_, old-naip_, ssimloss_, cliploss_ (its CLIP tower
  narrowed to test-tiny-siglip), osm_obj_esrgan, srcnn_ and
  highresnet_s2naip_urban) each run one iteration at small width,
  --auto_resume to a second from the .state, and write net_g (and net_d)
  .pth files that load back through the port's importer.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs import build_arch
from satlas_sr_tpu.utils.checkpoint import load_network_variables as jax_load
from satlas_sr_tpu.utils.checkpoint import load_pytree as jax_load_pytree
from satlas_sr_tpu.utils.imgio import write_png
from satlas_sr_tpu_torch import train as train_cli
from satlas_sr_tpu_torch.utils.checkpoint import load_state, verify_state_file
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_S2 = 2
SMALL_G = {"num_feat": 8, "num_block": 1, "num_grow_ch": 4}
SMALL_L2 = {"hidden_channels": 16, "revisits": N_S2}


def make_tree(root, rng, chips=4, bands=(), old_naip=False):
    for c in range(chips):
        chip = f"{700 + c}_{800 + c}"
        write_png(str(root / "naip" / chip / f"{chip}.png"),
                  (rng.rand(128, 128, 3) * 254 + 1).astype(np.uint8))
        write_png(str(root / "sentinel2" / chip / "tci.png"),
                  (rng.rand(N_S2 * 32, 32, 3) * 254 + 1).astype(np.uint8))
        for band in bands:
            write_png(str(root / "sentinel2" / chip / f"{band}.png"),
                      (rng.rand(N_S2 * 32, 32, 1) * 254 + 1).astype(np.uint8))
        if old_naip:
            write_png(str(root / "old_naip" / chip / f"{chip}.png"),
                      (rng.rand(128, 128, 3) * 254 + 1).astype(np.uint8))
    return root


def write_osm_boxes(data):
    """osm_chips_to_masks.json for the tree: 1 to 3 boxes a chip, one of
    them degenerate (x1 == x2)."""
    chips = sorted(os.listdir(data / "naip"))
    boxes = {chip: {"building": [[4 * i, 8, 4 * i + 30, 50], [60, 60, 60, 90]][: 1 + i % 2],
                    "road": [[0, 100, 128, 128]] if i % 3 == 0 else []}
             for i, chip in enumerate(chips)}
    with open(data / "osm_chips_to_masks.json", "w") as f:
        json.dump(boxes, f)
    return str(data / "osm_chips_to_masks.json")


def shipped(config, tmp_path, data, total_iter=2, **train):
    """A shipped train config at small width, float32, on this tree."""
    with open(os.path.join(ROOT, "options", config)) as f:
        opt = yaml.safe_load(f)
    opt["compute_dtype"] = "float32"
    if opt["model_type"] == "L2Model":
        opt["network_g"].update(SMALL_L2)
    else:
        opt["network_g"].update(SMALL_G)
        opt["network_d"]["num_feat"] = 4
        opt["train"]["perceptual_opt"]["layer_weights"] = {"conv1_2": 0.1}
        if opt["train"].get("clip_opt"):
            opt["train"]["clip_opt"]["clip_loss_model"] = "test-tiny-siglip"
    for phase in ("train", "val"):
        ds = opt["datasets"][phase]
        ds.update(sentinel2_path=str(data / "sentinel2"), naip_path=str(data / "naip"),
                  n_s2_images=N_S2)
        if ds.get("old_naip_path"):
            ds["old_naip_path"] = str(data / "old_naip")
    tr = opt["datasets"]["train"]
    tr.update(batch_size_per_gpu=2, num_worker_per_gpu=2)
    if tr.get("tile_weights"):
        chips = sorted(os.listdir(data / "naip"))
        with open(data / "weights.json", "w") as f:
            json.dump({chips[0]: 5.0, chips[1]: 0.5}, f)
        tr["tile_weights"] = str(data / "weights.json")
    if tr.get("osm_objs_path"):
        tr["osm_objs_path"] = write_osm_boxes(data)
    opt["train"].update(total_iter=total_iter, **train)
    opt["val"]["val_freq"] = 2
    opt["logger"].update(print_freq=1, save_checkpoint_freq=2, use_tb_logger=False)
    opt["path"]["experiments_root"] = str(tmp_path / "experiments")
    return opt


def write(opt, path):
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return str(path)


def run(tmp_path, opt, *flags):
    yml = write(opt, tmp_path / f"{opt['name']}.yml")
    train_cli.train_pipeline(str(tmp_path), ["-opt", yml, *flags], device="cpu")
    return tmp_path / "experiments" / opt["name"]


def train_rows(exp):
    rows = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    return [r for r in rows if "val_dataset" not in r]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A straight three-iteration run, its first iteration under the profiler,
    and two iterations + auto-resume to three."""
    tmp = tmp_path_factory.mktemp("train_cli")
    data = make_tree(tmp / "data", np.random.RandomState(0))
    out = {}
    for name, plan in (("straight", [(3, ())]), ("resumed", [(2, ()), (3, ("--auto_resume",))])):
        for total, flags in plan:
            opt = shipped("esrgan_s2naip_urban.yml", tmp, data, total_iter=total)
            opt["name"] = name
            if name == "straight":
                opt["logger"]["profile"] = {"num_iters": 1}
            exp = run(tmp, opt, *flags)
        out[name] = exp
    return out


def test_resume_is_bit_identical_to_a_straight_run(runs):
    straight, resumed = runs["straight"], runs["resumed"]
    assert (resumed / "training_states" / "2.state").exists()
    for net in ("g", "d"):
        a = torch.load(straight / "models" / f"net_{net}_latest.pth", weights_only=True)
        b = torch.load(resumed / "models" / f"net_{net}_latest.pth", weights_only=True)
        assert sorted(a) == sorted(b) == (["params", "params_ema"] if net == "g" else ["params"])
        for key in a:
            assert sorted(a[key]) == sorted(b[key])
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name]), (net, key, name)
    rows_a, rows_b = train_rows(straight), train_rows(resumed)
    assert [r["iter"] for r in rows_b] == [1, 2, 3]  # the resume continued at 3
    for ra, rb in zip(rows_a, rows_b):
        assert {k: v for k, v in ra.items() if k.startswith("l_")} == \
            {k: v for k, v in rb.items() if k.startswith("l_")}
    d_params = torch.load(resumed / "models" / "net_d_latest.pth", weights_only=True)["params"]
    assert any(k.endswith("weight_u") for k in d_params)


def test_state_file_holds_the_training_state(runs):
    blob = load_state(str(runs["resumed"] / "training_states" / "latest.state"))
    assert blob["iter"] == 3
    state = blob["state"]
    assert state["step"] == 3 and state["g"]["updates"] == 3 and state["d"]["updates"] == 3
    assert set(state) == {"step", "g", "d", "ema"}
    assert state["g"]["opt"]["state"] and state["d"]["opt"]["state"]  # Adam moments
    assert any(k.endswith("weight_v") for k in state["d"]["params"])
    # beside each .pth the JAX package's .msgpack, which its own reader loads
    models = runs["resumed"] / "models"
    pths = sorted(p.stem for p in models.glob("*.pth"))
    assert pths and pths == sorted(p.stem for p in models.glob("*.msgpack"))
    g = jax_load_pytree(str(models / "net_g_latest.msgpack"))
    assert set(g) == {"params", "params_ema"} and "body" in g["params"]
    assert set(jax_load_pytree(str(models / "net_d_latest.msgpack"))) == {"params", "spectral"}


def test_jax_package_loads_the_ports_generator(runs, rng):
    path = str(runs["straight"] / "models" / "net_g_latest.pth")
    net = {"type": "SSR_RRDBNet", "num_in_ch": 3 * N_S2, "num_out_ch": 3, **SMALL_G}
    variables = jax_load("SSR_RRDBNet", path, net, "params_ema")
    x = rng.rand(2, 32, 32, 3 * N_S2).astype(np.float32)
    want = jax.jit(build_arch(net).apply)({"params": variables["params"]}, jnp.asarray(x))
    from satlas_sr_tpu_torch.archs import RRDBNet

    port = RRDBNet(num_in_ch=3 * N_S2, num_out_ch=3, device="cpu", **{
        "num_feat": 8, "num_block": 1, "num_grow_ch": 4})
    port.load_state_dict(torch.load(path, weights_only=True)["params_ema"])
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_auto_resume_skips_a_torn_state(runs, tmp_path):
    from satlas_sr_tpu_torch.train import find_resume_state

    states = tmp_path / "training_states"
    states.mkdir()
    src = runs["resumed"] / "training_states"
    for name in ("2.state", "latest.state"):
        (states / name).write_bytes((src / name).read_bytes())
    torn = (src / "latest.state").read_bytes()
    (states / "5.state").write_bytes(torn[: len(torn) // 2])
    flipped = bytearray(torn)
    flipped[100] ^= 0xFF
    (states / "4.state").write_bytes(bytes(flipped))
    assert not verify_state_file(str(states / "5.state"))
    assert not verify_state_file(str(states / "4.state"))
    found = find_resume_state({"auto_resume": True, "path": {"training_states": str(states)}})
    assert found == str(states / "2.state")


@pytest.mark.parametrize("config,key,item", [
    ("esrgan_s2naip_urban.yml", "checkpoint_backend", 14),
])
def test_unported_training_is_refused(tmp_path, rng, config, key, item):
    """Once refused naming ROADMAP item 14, `checkpoint_backend: orbax` now
    trains: torch.distributed.checkpoint steps (utils/orbax_io.py) beside
    the .pth mirror, no native .state."""
    data = make_tree(tmp_path / "data", rng, chips=2)
    extra = {"checkpoint_backend": "orbax"} if key == "checkpoint_backend" else {}
    opt = shipped(config, tmp_path, data, **extra)
    exp = run(tmp_path, opt)
    states = exp / "training_states"
    assert sorted(os.listdir(states / "orbax")) == [str(opt["train"]["total_iter"])]
    assert not list(states.glob("*.state"))
    assert (exp / "models" / "net_g_latest.pth").exists()
    assert (exp / "models" / "net_d_latest.pth").exists()


def test_cuda_without_a_card_raises(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    data = make_tree(tmp_path / "data", rng, chips=2)
    yml = write(shipped("esrgan_s2naip_urban.yml", tmp_path, data), tmp_path / "o.yml")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.train_pipeline(str(tmp_path), ["-opt", yml])
    assert not (tmp_path / "experiments").exists()


@pytest.mark.parametrize("config", ["esrgan_s2naip_urban.yml", "esrgan_s2naip_full.yml",
                                    "rand_crop_esrgan_s2naip_urban.yml",
                                    "allbands_esrgan_s2naip_urban.yml",
                                    "old-naip_esrgan_s2naip_urban.yml",
                                    "ssimloss_esrgan_s2naip_urban.yml",
                                    "cliploss_esrgan_s2naip_urban.yml", "osm_obj_esrgan.yml",
                                    "srcnn_s2naip_urban.yml", "highresnet_s2naip_urban.yml"])
def test_shipped_esrgan_configs_train(tmp_path, rng, config):
    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.utils.checkpoint import load_network_variables

    with open(os.path.join(ROOT, "options", config)) as f:
        bands = [b for b in yaml.safe_load(f)["datasets"]["train"].get("s2_bands") or [] if b != "tci"]
    data = make_tree(tmp_path / "data", rng, bands=bands, old_naip="old-naip" in config)
    opt = shipped(config, tmp_path, data, total_iter=1)
    opt["val"]["val_freq"] = 1
    exp = run(tmp_path, opt)
    opt["train"]["total_iter"] = 2
    run(tmp_path, opt, "--auto_resume")
    rows = train_rows(exp)
    assert [r["iter"] for r in rows] == [1, 2]  # the second run resumed from latest.state
    assert all(np.isfinite(v) for r in rows for k, v in r.items()
               if k.startswith(("l_", "out_")) or k in ("mse", "mae", "ssim", "tot_loss"))
    l2 = opt["model_type"] == "L2Model"
    expected = {"SSRESRGANModel": ["l_g_pix", "l_g_percep", "l_g_gan"],
                "OSMObjESRGANModel": ["l_g_pix", "l_g_percep", "l_g_gan", "l_g_gan_objs",
                                      "l_d_real_objs", "l_d_fake_objs"],
                "L2Model": ["mse", "mae", "ssim", "tot_loss", "psnr_loss"]}[opt["model_type"]]
    if "ssim_opt" in opt["train"]:
        expected.append("l_g_ssim")
    if "clip_opt" in opt["train"]:
        expected.append("l_clip_sim")
    assert set(expected) <= set(rows[0])
    # the .pth files load back through the port's importer into a fresh network
    g_state = load_network_variables(opt["network_g"]["type"],
                                     str(exp / "models" / "net_g_latest.pth"), opt["network_g"],
                                     "params_ema")
    fresh = build_model({**opt, "is_train": False, "path": {}, "test": None}, device="cpu").net_g
    fresh.load_state_dict(g_state)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in g_state.items())
    if l2:
        assert not (exp / "models" / "net_d_latest.pth").exists()
        return
    d_type = opt["network_d"]["type"]
    d_state = load_network_variables(d_type, str(exp / "models" / "net_d_latest.pth"),
                                     opt["network_d"], "params")
    d = torch.load(exp / "models" / "net_d_latest.pth", weights_only=True)["params"]
    # the D's input: the output, the LR (feed_disc_lr) and the old NAIP where configured
    disc_in = 3 + N_S2 * (3 + len(bands)) + (3 if "old-naip" in config else 0)
    assert d["conv0.weight"].shape[1] == disc_in  # reference names: the U-Net at the top level
    model = build_model({**opt, "is_train": True}, device="cpu")
    model.net_d.load_state_dict(d_state)
    assert isinstance(model.net_g, RRDBNet)


def test_sigterm_saves_the_state_and_stops(tmp_path, rng, monkeypatch):
    """SIGTERM only sets a flag: the loop saves the training state at the next
    iteration boundary and returns, and --auto_resume continues from it."""
    import signal

    from satlas_sr_tpu_torch.models.esrgan import ESRGANModel

    data = make_tree(tmp_path / "data", rng, chips=2)
    opt = shipped("esrgan_s2naip_urban.yml", tmp_path, data, total_iter=3)
    orig = ESRGANModel.train_iter

    def train_iter(self, batch, current_iter):
        logs = orig(self, batch, current_iter)
        if current_iter == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return logs

    monkeypatch.setattr(ESRGANModel, "train_iter", train_iter)
    exp = run(tmp_path, opt)
    assert sorted(os.listdir(exp / "training_states")) == ["1.state"]
    assert [r["iter"] for r in train_rows(exp)] == [1]
    monkeypatch.setattr(ESRGANModel, "train_iter", orig)
    run(tmp_path, opt, "--auto_resume")
    assert [r["iter"] for r in train_rows(exp)] == [1, 2, 3]


def test_profile_window_writes_a_trace(runs):
    traces = list((runs["straight"] / "profile").glob("trace_*.json"))
    assert [t.name for t in traces] == ["trace_1.json"]
    assert json.loads(traces[0].read_text())["traceEvents"]


@pytest.mark.parametrize("argv", [[], ["--debug"],
                                  ["--auto_resume", "--force_yml", "manual_seed=7",
                                   "train:ema_decay=0.5", "train:accum_steps=2"]],
                         ids=["plain", "debug", "resume_force"])
def test_train_options_match_jax(tmp_path, argv):
    """The train side of parse_options gives the JAX package's options, but
    `num_gpu: auto`, which is 1 here (one card a process) and the local
    device count there."""
    from satlas_sr_tpu.utils.options import parse_options as jax_parse_options
    from satlas_sr_tpu_torch.utils.options import parse_options

    yml = os.path.join(ROOT, "options", "esrgan_s2naip_urban.yml")
    got, _ = parse_options(str(tmp_path), True, ["-opt", yml, *argv])
    want, _ = jax_parse_options(str(tmp_path), True, ["-opt", yml, *argv])
    assert got["num_gpu"] == 1
    for opt in (got, want):
        opt.pop("num_gpu")
    assert got == want

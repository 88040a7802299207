"""The port's `test` CLI (satlas_sr_tpu_torch.test) against the JAX package's.

The shipped train configs (options/esrgan_s2naip_urban.yml,
srcnn_s2naip_urban.yml, highresnet_s2naip_urban.yml, osm_obj_esrgan.yml) are
loaded, narrowed in code to small widths, float32 with TF32 off and the
metrics psnr/ssim/cpsnr (the tower metrics have their own test below),
and written to a temporary yml; both CLIs run it on the same synthetic
S2-NAIP tree (one chip with a black NAIP pixel, which the dataset skips) and
the same reference-format .pth. Held: metric values |d| <= 0.01 dB (PSNR,
cPSNR) and <= 1e-4 (SSIM), visualization PNGs within 1 level on <= 0.1% of
values, the same results.json keys and metrics.jsonl rows. The shipped
LPIPS and CLIPScore entries run and are tagged `(untrained-tower)` on the
random towers; `clip_opt` builds the CLIP loss. Also device="cuda" without
a card raises, and `--launcher pytorch` at world size 1 (gloo) equals the
run without a launcher.
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
from satlas_sr_tpu import test as jax_test
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu.utils.imgio import read_png, write_png
from satlas_sr_tpu_torch.models import build_model
from satlas_sr_tpu_torch import test as port_test
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CHIPS, FRAMES, N_S2 = 4, 3, 2
SMALL = {
    "SSR_RRDBNet": {"num_feat": 8, "num_block": 2, "num_grow_ch": 4},
    "SRCNN": {"hidden_channels": 16, "revisits": N_S2},
    "HighResNet": {"hidden_channels": 16, "revisits": N_S2},
}
METRICS = ("psnr", "ssim", "cpsnr")


def make_tree(root, rng):
    for c in range(N_CHIPS):
        chip = f"{300 + c}_{400 + c}"
        naip = (rng.rand(128, 128, 3) * 254 + 1).astype(np.uint8)
        if c == 1:
            naip[5, 7] = 0  # a black NAIP pixel: skip-and-advance takes the next chip
        write_png(str(root / "naip" / chip / f"{chip}.png"), naip)
        s2 = (rng.rand(FRAMES * 32, 32, 3) * 254 + 1).astype(np.uint8)
        write_png(str(root / "sentinel2" / chip / "tci.png"), s2)
    return str(root / "sentinel2"), str(root / "naip")


def shipped_opt(config, tmp_path, s2, naip, weights):
    """A shipped train config, narrowed: small widths, float32, the weight-free
    metrics, this tree and these weights."""
    with open(os.path.join(ROOT, "options", config)) as f:
        opt = yaml.safe_load(f)
    opt["name"] = "cli_" + config[:-len(".yml")]
    opt["matmul_precision"] = "highest"
    net = opt["network_g"]
    net.update(SMALL[net["type"]])
    opt["datasets"]["train"]["n_s2_images"] = N_S2
    opt["datasets"]["train"].pop("osm_objs_path", None)
    test = opt["test_datasets"]["test"]
    test.update(sentinel2_path=s2, naip_path=naip, n_s2_images=N_S2)
    opt["test"]["metrics"] = {k: v for k, v in opt["test"]["metrics"].items() if k in METRICS}
    opt["path"].update(pretrain_network_g=weights, param_key_g="params_ema")
    path = tmp_path / f"{opt['name']}.yml"
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return opt, str(path)


def jax_weights(opt, path):
    """Seeded JAX generator weights exported as a reference-format .pth."""
    net = dict(opt["network_g"])
    if net["type"] == "SSR_RRDBNet":
        net["num_in_ch"] = 3 * N_S2
        x = jnp.zeros((1, 32, 32, 3 * N_S2))
    else:
        x = jnp.zeros((1, N_S2, 32, 32, 3))
    arch = net["type"]
    variables = build_arch(net).init({"params": jax.random.PRNGKey(3),
                                      "dropout": jax.random.PRNGKey(4)}, x)
    state = jax_torch_io.export_torch_state(arch, {"params": variables["params"]})
    jax_torch_io.save_torch_state_dict(path, state, param_key="params_ema")


def run_both(config, tmp_path, rng):
    s2, naip = make_tree(tmp_path / "data", rng)
    weights = str(tmp_path / "net_g.pth")
    opt, yml = shipped_opt(config, tmp_path, s2, naip, weights)
    jax_weights(opt, weights)
    argv = ["-opt", yml, "--force_yml", "compute_dtype=float32"]
    got = port_test.test_pipeline(str(tmp_path / "port"), argv, device="cpu")
    want = jax_test.test_pipeline(str(tmp_path / "jax"), argv)
    return opt, got, want


def vis_pngs(root, name):
    vis = root / "results" / name / "visualization" / "test"
    return {p.name: read_png(str(p)) for p in sorted(vis.glob("*.png"))}


@pytest.mark.parametrize("config", ["esrgan_s2naip_urban.yml", "srcnn_s2naip_urban.yml",
                                    "highresnet_s2naip_urban.yml", "osm_obj_esrgan.yml"])
def test_test_cli_matches_jax(tmp_path, rng, config):
    opt, got, want = run_both(config, tmp_path, rng)
    assert set(got) == set(want) == {"test"}
    assert set(got["test"]) == set(want["test"]) == set(METRICS)
    for m in METRICS:
        tol = 1e-4 if m == "ssim" else 0.01
        assert abs(got["test"][m] - want["test"][m]) <= tol, (m, got, want)
        assert np.isfinite(got["test"][m])

    name = opt["name"]
    port_pngs, jax_pngs = vis_pngs(tmp_path / "port", name), vis_pngs(tmp_path / "jax", name)
    assert sorted(port_pngs) == sorted(jax_pngs)
    assert len(port_pngs) == 2 * N_CHIPS  # sr and gt per chip
    for fname, img in port_pngs.items():
        ref = jax_pngs[fname]
        assert img.shape == ref.shape == (128, 128, 3)
        d = np.abs(img.astype(np.int16) - ref.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (fname, d.max(), (d > 0).mean())
        if fname.endswith("_gt.png"):
            np.testing.assert_array_equal(img, ref)

    summaries = [json.loads((tmp_path / r / "results" / name / "results.json").read_text())
                 for r in ("port", "jax")]
    assert set(summaries[0]) == set(summaries[1]) == {
        "name", "weights", "param_key_g", "results", "timestamp"}
    for key in ("name", "weights", "param_key_g"):
        assert summaries[0][key] == summaries[1][key]
    rows = [[json.loads(line) for line in
             (tmp_path / r / "results" / name / "metrics.jsonl").read_text().splitlines()]
            for r in ("port", "jax")]
    assert [sorted(r) for r in rows[0]] == [sorted(r) for r in rows[1]]
    assert rows[0][0]["iter"] == name and rows[0][0]["val_dataset"] == "test"


def _small_opt(tmp_path, **extra):
    opt = {"name": "refuse", "model_type": "SSRESRGANModel", "scale": 4, "manual_seed": 0,
           "network_g": {"type": "SSR_RRDBNet", "num_in_ch": 6, "num_out_ch": 3,
                         "num_feat": 8, "num_block": 1, "num_grow_ch": 4},
           "path": {}, "is_train": False}
    opt.update(extra)
    return opt


@pytest.mark.parametrize("metric", ["lpips", "clipscore"])
def test_shipped_tower_metric_runs_and_is_tagged(tmp_path, rng, metric):
    """esrgan_s2naip_urban.yml's own `lpips` / `clipscore` entry (CLIPScore's
    tower narrowed to test-tiny-siglip) runs in the port's test CLI: its
    average is the mean of the metric over the saved SR/GT pairs on every
    chip, each within 1e-5 of the JAX package's metric of the same pair;
    tagged `(untrained-tower)` on the random tower, untagged with a weights
    file."""
    from satlas_sr_tpu import metrics as jax_metrics
    from satlas_sr_tpu_torch import metrics as port_metrics
    from test_torch_towers import _timm_vit_state
    from test_tower_import import _lpips_state

    s2, naip = make_tree(tmp_path / "data", rng)
    weights = str(tmp_path / "net_g.pth")
    opt, _ = shipped_opt("esrgan_s2naip_urban.yml", tmp_path, s2, naip, weights)
    jax_weights(opt, weights)
    with open(os.path.join(ROOT, "options", "esrgan_s2naip_urban.yml")) as f:
        m_opt = yaml.safe_load(f)["test"]["metrics"][metric]
    if metric == "clipscore":
        m_opt["clip_model"] = "test-tiny-siglip"
    tower_pth = str(tmp_path / f"{metric}.pth")
    torch.save(_lpips_state(rng, "vgg") if metric == "lpips" else _timm_vit_state(rng), tower_pth)
    key = "lpips_weights_path" if metric == "lpips" else "clip_weights_path"
    for tag, extra in (("(untrained-tower)", {}), ("", {key: tower_pth})):
        name = f"tower_{metric}{'_weights' if extra else ''}"
        o = {**opt, "name": name, "test": {**opt["test"], "save_img": True,
                                           "metrics": {metric: {**m_opt, **extra}}}}
        yml = tmp_path / f"{name}.yml"
        with open(yml, "w") as f:
            yaml.safe_dump(o, f)
        got = port_test.test_pipeline(str(tmp_path / "port"), ["-opt", str(yml)], device="cpu")
        assert list(got["test"]) == [metric + tag]
        pngs = vis_pngs(tmp_path / "port", name)
        pairs = [(pngs[k], pngs[k[:-len(".png")] + "_gt.png"]) for k in sorted(pngs)
                 if not k.endswith("_gt.png")]
        assert len(pairs) == N_CHIPS
        each = [port_metrics.calculate_metric({"img": a, "img2": b}, o["test"]["metrics"][metric],
                                              device="cpu") for a, b in pairs]
        want = [jax_metrics.calculate_metric({"img": a, "img2": b}, o["test"]["metrics"][metric])
                for a, b in pairs]
        np.testing.assert_allclose(each, want, rtol=0, atol=1e-5)
        assert abs(got["test"][metric + tag] - np.mean(each)) <= 1e-6


@pytest.mark.parametrize("model_type,train,item", [
    ("SSRESRGANModel", {"accum_steps": 2}, 16),
    ("OSMObjESRGANModel", {"accum_steps": 2}, 16),
    ("L2Model", {"accum_steps": 2}, 16)])
def test_training_is_refused(tmp_path, model_type, train, item):
    """Gradient accumulation (ROADMAP queue 1 item 16, once refused at model
    build) now builds in all three trainer families: a train batch of
    k x b rows splits into k micro-batches of b on the device, and a row
    count k does not divide raises the JAX package's ValueError
    (tests/test_torch_accum.py holds the steps against JAX)."""
    from test_torch_esrgan_train import small_opt as esrgan_opt
    from test_torch_l2_train import small_opt as l2_opt
    from test_torch_osm_train import small_opt as osm_opt

    opt = {"SSRESRGANModel": lambda: esrgan_opt(tmp_path), "OSMObjESRGANModel": lambda: osm_opt(None),
           "L2Model": lambda: l2_opt("SRCNN")}[model_type]()
    opt["train"].update(train)
    model = build_model(opt, device="cpu")
    assert item == 16 and model.accum_steps == train["accum_steps"] == 2
    parts = model.micro_batches(np.arange(4 * 3).reshape(4, 3))
    assert [tuple(p.shape) for p in parts] == [(2, 3), (2, 3)]
    assert torch.equal(parts[1], torch.tensor([[6, 7, 8], [9, 10, 11]]))
    with pytest.raises(ValueError, match="not divisible by accum_steps=2"):
        model.micro_batches(np.zeros((3, 2)))


@pytest.mark.parametrize("model_type", ["SSRESRGANModel", "OSMObjESRGANModel"])
def test_clip_opt_builds_a_frozen_loss_tower(tmp_path, model_type):
    """`train.clip_opt` builds the CLIP loss (no longer refused): the model
    computes it on G's output with a frozen tower outside G's optimizer."""
    from satlas_sr_tpu_torch.metrics.clip_encoder import get_encoder

    clip = {"type": "CLIPLoss", "clip_loss_model": "test-tiny-siglip", "loss_weight": 1.0}
    opt = _small_opt(tmp_path, model_type=model_type, is_train=True, train={
        "clip_opt": clip, "optim_g": {"type": "Adam", "lr": 1e-4},
        "optim_d": {"type": "Adam", "lr": 1e-4}},
        network_d={"type": "SSR_UNetDiscriminatorSN", "num_feat": 4})
    model = build_model(opt, device="cpu")
    assert model.clip_sim is not None and model._g_log_keys()[-1 - (
        model_type == "OSMObjESRGANModel")] == "l_clip_sim"
    x = torch.rand(1, 128, 128, 3, requires_grad=True)
    loss = model.clip_sim(x, torch.rand(1, 128, 128, 3))
    loss.backward()
    assert loss.item() > 0 and x.grad.abs().sum() > 0
    tower, _ = get_encoder("test-tiny-siglip", device="cpu")
    assert not any(p.requires_grad for p in tower.parameters())
    assert not {id(p) for p in tower.parameters()} & {
        id(p) for g in model.opt_g.param_groups for p in g["params"]}


def test_eval_forward_rounds_where_infer_truncates(tmp_path, rng):
    """to_uint8 rounds (validation); the infer engine truncates: on the same
    weights and input they differ by at most one level, and the rounded one
    is what rint of the float output gives."""
    from satlas_sr_tpu_torch.inference import InferenceEngine

    model = build_model(_small_opt(tmp_path), device="cpu")
    x = (rng.rand(2, 32, 32, 6) * 255).astype(np.uint8)
    rounded = model.eval_outputs({"lr": x}).numpy()
    with torch.no_grad():
        y = model.net_g(torch.from_numpy(x).float() / 255.0).clamp(0, 1).numpy()
    np.testing.assert_array_equal(rounded, np.rint(y * 255.0).astype(np.uint8))
    truncated = InferenceEngine(model.net_g, batch_size=2, device="cpu").run(x)
    d = rounded.astype(np.int16) - truncated.astype(np.int16)
    assert d.min() >= 0 and d.max() <= 1 and d.any()


def test_cuda_without_a_card_raises(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    s2, naip = make_tree(tmp_path / "data", rng)
    _, yml = shipped_opt("esrgan_s2naip_urban.yml", tmp_path, s2, naip, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_test.test_pipeline(str(tmp_path / "port"), ["-opt", yml])
    assert not (tmp_path / "port" / "results").exists()


def test_launcher_is_refused(tmp_path, rng, monkeypatch):
    """Once refused naming ROADMAP item 14, `--launcher pytorch` now runs the
    test CLI as a torch.distributed rank: at world size 1 (gloo, env:// on a
    free port) its metrics equal the run without a launcher."""
    import socket

    from satlas_sr_tpu_torch.utils.options import close_distributed

    s2, naip = make_tree(tmp_path / "data", rng)
    _, yml = shipped_opt("esrgan_s2naip_urban.yml", tmp_path, s2, naip, None)
    want = port_test.test_pipeline(str(tmp_path / "one"), ["-opt", yml], device="cpu")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(key, value)
    try:
        got = port_test.test_pipeline(str(tmp_path / "port"), ["-opt", yml, "--launcher", "pytorch"],
                                      device="cpu")
        assert torch.distributed.get_world_size() == 1
    finally:
        close_distributed()
    assert got == want and want["test"]

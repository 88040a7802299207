"""The whole slice: the port's infer CLI against the JAX package's on one tree.

One synthetic S2-NAIP tree and one reference-format .pth go through
satlas_sr_tpu.infer.run_inference and satlas_sr_tpu_torch.infer.run_inference
(device="cpu"). Both write the same files; lr.png holds the same pixels;
sr.png is 128x128x3 uint8 and differs from the JAX output by at most one
level on at most 0.1% of the values (truncation turns a ~1e-6 float
difference at a quantisation boundary into one level).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs import RRDBNet as JaxRRDBNet
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.infer import main as port_main, run_inference as port_run
from satlas_sr_tpu_torch.utils.imgio import read_png, write_png
from torch_threads import two_torch_threads  # noqa: F401

N_FRAMES = 2
NET = dict(num_in_ch=N_FRAMES * 3, num_out_ch=3, num_feat=8, num_block=1, num_grow_ch=4)


def _weights(tmp_path):
    v = JaxRRDBNet(**NET).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, N_FRAMES * 3)))
    path = str(tmp_path / "net_g.pth")
    jax_torch_io.save_torch_state_dict(path, jax_torch_io.rrdbnet_to_torch(v), param_key="params_ema")
    return path


def _opt(weights, data_dir, save_path, batch_size=2):
    return {
        "data_dir": str(data_dir), "save_path": str(save_path),
        "n_lr_images": N_FRAMES, "scale": 4, "batch_size": batch_size,
        "network_g": {"type": "SSR_RRDBNet", **NET},
        "path": {"pretrain_network_g": weights, "param_key_g": "params_ema"},
    }


def _write_s2_png(path, rng, n_frames=4, black_frame=None):
    data = (rng.rand(n_frames * 32, 32, 3) * 254 + 1).astype(np.uint8)
    if black_frame is not None:
        data[black_frame * 32: black_frame * 32 + 4] = 0
    write_png(str(path), data)


def _tree(tmp_path, rng, n):
    data_dir = tmp_path / "sentinel2" / "sub"
    os.makedirs(data_dir)
    for i in range(n):
        _write_s2_png(data_dir / f"{i}.png", rng, black_frame=1 if i == 0 else None)
    return tmp_path / "sentinel2"


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_port_infer_matches_jax_infer(tmp_path, rng):
    from satlas_sr_tpu.infer import run_inference as jax_run

    weights = _weights(tmp_path)
    data = _tree(tmp_path, rng, 5)  # batch 2: two full batches and a padded one
    assert jax_run(_opt(weights, data, tmp_path / "jax")) == 5
    assert port_run(_opt(weights, data, tmp_path / "port"), device="cpu") == 5
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    diffs = []
    for i in range(5):
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / str(i) / "lr.png")),
                                      read_png(str(tmp_path / "jax" / str(i) / "lr.png")))
        sr = read_png(str(tmp_path / "port" / str(i) / "sr.png"))
        assert sr.shape == (128, 128, 3) and sr.dtype == np.uint8
        diffs.append(np.abs(sr.astype(int) - read_png(str(tmp_path / "jax" / str(i) / "sr.png")).astype(int)))
    diffs = np.stack(diffs)
    assert diffs.max() <= 1
    assert (diffs > 0).mean() <= 1e-3


def test_port_infer_cli_skip_existing_resume(tmp_path, rng):
    """skip_existing recomputes only the missing outputs, bit-identically,
    through the `-opt <yml>` entry point."""
    import shutil

    import yaml

    weights = _weights(tmp_path)
    data = _tree(tmp_path, rng, 4)
    save = tmp_path / "out"
    opt = _opt(weights, data, save)
    assert port_run(opt, device="cpu") == 4
    full = {i: read_png(str(save / str(i) / "sr.png")) for i in range(4)}
    shutil.rmtree(save / "1")
    os.remove(save / "3" / "lr.png")
    kept_mtime = os.path.getmtime(save / "2" / "sr.png")

    opt["skip_existing"] = True
    opt_path = tmp_path / "opt.yml"
    with open(opt_path, "w") as f:
        yaml.safe_dump(opt, f)
    port_main(["-opt", str(opt_path), "--device", "cpu"])
    for i in range(4):
        np.testing.assert_array_equal(read_png(str(save / str(i) / "sr.png")), full[i])
    assert os.path.getmtime(save / "2" / "sr.png") == kept_mtime
    assert port_run(opt, device="cpu") == 0


def test_port_infer_manifest_guard(tmp_path, rng):
    weights = _weights(tmp_path)
    data = _tree(tmp_path, rng, 3)
    save = tmp_path / "out"
    opt = _opt(weights, data, save)
    opt["skip_existing"] = True
    assert port_run(opt, device="cpu") == 3
    assert (save / ".ssr_corpus_manifest.json").exists()
    _write_s2_png(data / "sub" / "8.png", rng)  # tail append: accepted
    assert port_run(opt, device="cpu") == 1
    os.remove(data / "sub" / "1.png")  # shifts later indices: refused
    with pytest.raises(RuntimeError, match="corpus changed"):
        port_run(opt, device="cpu")
    assert port_run(opt, force=True, device="cpu") >= 0
    assert port_run(opt, device="cpu") == 0


@pytest.mark.parametrize("n", [3, 5])  # a partial batch, padded; a full one
def test_prep_batch_matches_jax(rng, n):
    from satlas_sr_tpu.inference import prep_batch as jax_prep
    from satlas_sr_tpu_torch.inference import prep_batch

    x = (rng.rand(n, 32, 32, 12) * 255).astype(np.uint8)
    np.testing.assert_array_equal(prep_batch(x, 5), jax_prep(x, 5))


def test_engine_buckets_pad_and_strip(rng):
    """A partial batch pads to the batch size and comes back at its own
    length, equal to the same images run in a full batch."""
    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.inference import InferenceEngine

    engine = InferenceEngine(RRDBNet(device="cpu", **NET), batch_size=4, device="cpu")
    x = (rng.rand(4, 32, 32, N_FRAMES * 3) * 255).astype(np.uint8)
    full = engine.run(x)
    got = engine.run(x[:2])
    assert got.shape == (2, 128, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, full[:2])

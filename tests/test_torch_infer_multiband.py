"""Multi-band GT-free inference (`s2_bands`): the port's infer CLI against the
JAX package's on one corpus of chip directories.

A 10m-like config (bands tci + b08: 4 channels a frame, num_in_ch 8 for two
frames), small widths, float32. One chip lacks b08.png (zero-filled at
tci's frame count), one has a black tci frame. sr.png is 128x128x3 and
within one level of the JAX output on at most 0.1% of the values; lr.png
(the tci preview) is equal. A band whose frame count differs from tci's
raises in both.
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
from satlas_sr_tpu_torch.utils.infer_utils import (channels_per_frame, format_s2naip_multiband_batch,
                                                   load_band_stack, normalize_bands)
from torch_threads import two_torch_threads  # noqa: F401

N_FRAMES = 2
BANDS = ["b08", "tci"]  # tci goes first: 3 + 1 channels a frame
NET = dict(type="SSR_RRDBNet", num_in_ch=N_FRAMES * 4, num_out_ch=3, num_feat=8, num_block=1,
           num_grow_ch=4)


def make_chip(root, chip, rng, frames=4, with_b08=True, black_frame=None, b08_frames=None):
    d = os.path.join(str(root), chip)
    tci = (rng.rand(frames * 32, 32, 3) * 254 + 1).astype(np.uint8)
    if black_frame is not None:
        tci[black_frame * 32: black_frame * 32 + 4] = 0
    write_png(os.path.join(d, "tci.png"), tci)
    if with_b08:
        n = b08_frames if b08_frames is not None else frames
        write_png(os.path.join(d, "b08.png"), (rng.rand(n * 32, 32, 1) * 254 + 1).astype(np.uint8))
    return d


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("bands")
    rng = np.random.RandomState(0)
    for i in range(5):
        make_chip(root / "data" / "sub", f"chip{i}", rng, with_b08=(i != 2),
                  black_frame=1 if i == 0 else None)
    m = JaxRRDBNet(num_in_ch=N_FRAMES * 4, num_out_ch=3, num_feat=8, num_block=1, num_grow_ch=4)
    v = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, N_FRAMES * 4)))
    weights = str(root / "net_g.pth")
    jax_torch_io.save_torch_state_dict(weights, jax_torch_io.rrdbnet_to_torch(v), "params_ema")
    return root, weights


def _opt(root, weights, save):
    return {"data_dir": str(root / "data"), "save_path": str(root / save), "n_lr_images": N_FRAMES,
            "scale": 4, "s2_bands": BANDS, "batch_size": 2, "compute_dtype": "float32",
            "matmul_precision": "highest", "network_g": NET,
            "path": {"pretrain_network_g": weights, "param_key_g": "params_ema"}}


def test_port_cli_matches_jax_cli(corpus):
    import yaml

    from satlas_sr_tpu.infer import run_inference as jax_run

    root, weights = corpus
    assert jax_run(_opt(root, weights, "jax")) == 5
    opt_path = root / "opt.yml"
    opt_path.write_text(yaml.safe_dump(_opt(root, weights, "port")))
    port_main(["-opt", str(opt_path), "--device", "cpu"])
    diffs = []
    for i in range(5):
        np.testing.assert_array_equal(read_png(str(root / "port" / str(i) / "lr.png")),
                                      read_png(str(root / "jax" / str(i) / "lr.png")))
        sr = read_png(str(root / "port" / str(i) / "sr.png"))
        assert sr.shape == (128, 128, 3) and sr.dtype == np.uint8
        diffs.append(np.abs(sr.astype(int) - read_png(str(root / "jax" / str(i) / "sr.png")).astype(int)))
    diffs = np.stack(diffs)
    assert diffs.max() <= 1 and (diffs > 0).mean() <= 1e-3


def test_formatting_matches_jax(corpus):
    from satlas_sr_tpu.utils.infer_utils import format_s2naip_multiband_batch as jax_fmt

    root, _ = corpus
    chips = sorted(str(p) for p in (root / "data" / "sub").iterdir())
    bands = normalize_bands(BANDS)
    assert bands == ["tci", "b08"] and channels_per_frame(BANDS) == 4
    got, previews = format_s2naip_multiband_batch(chips, bands, 3, seed=5, indices=[4, 0, 2, 1, 3])
    want, want_previews = jax_fmt(chips, bands, 3, seed=5, indices=[4, 0, 2, 1, 3])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.stack(previews), np.stack(want_previews))
    stack = load_band_stack(chips[2], bands)  # no b08.png: zeros at tci's frame count
    assert stack.shape == (4, 32, 32, 4) and not stack[..., 3].any()


def test_frame_count_mismatch_raises(tmp_path, corpus):
    from satlas_sr_tpu.infer import run_inference as jax_run

    _, weights = corpus
    make_chip(tmp_path / "data", "bad", np.random.RandomState(1), b08_frames=3)
    for run in (jax_run, lambda o: port_run(o, device="cpu")):
        with pytest.raises(ValueError, match="3 frames but tci has 4"):
            run(_opt(tmp_path, weights, "out"))


def test_bands_refused_with_grid_naming_and_3d_models(tmp_path, corpus):
    _, weights = corpus
    opt = _opt(tmp_path, weights, "out")
    with pytest.raises(ValueError, match="not supported for infer_grid"):
        port_run(opt, grid_naming=True, device="cpu")
    srcnn = {"type": "SRCNN", "in_channels": 3, "hidden_channels": 16, "out_channels": 3,
             "kernel_size": 3, "residual_layers": 1, "output_size": 128, "sr_kernel_size": 1}
    with pytest.raises(ValueError, match="requires SSR_RRDBNet"):
        port_run({**opt, "network_g": srcnn}, device="cpu")

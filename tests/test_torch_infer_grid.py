"""The port's infer_grid CLI against the JAX package's, on one 16x16-chunk tile.

Chunked + stitch, whole-tile (SSR_RRDBNet and SRCNN) and halo: the same tile
and the same reference-format .pth go through satlas_sr_tpu.infer_grid and
satlas_sr_tpu_torch.infer_grid (device="cpu"), small widths, float32. The
stitched outputs (2048x2048x3 SR, 512x512x3 S2) differ by at most one level
on at most 0.1% of the values (truncating quantisation turns a ~1e-6 float
difference at a level boundary into one level); stitched_s2.png is equal.
Also: skip_existing resume, the mutated-corpus refusal, and what the modes
refuse.
"""

import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp

from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch import infer_grid as port_grid
from satlas_sr_tpu_torch.utils.imgio import read_png, write_png
from torch_threads import two_torch_threads  # noqa: F401

N_FRAMES = 2
RRDB = dict(type="SSR_RRDBNet", num_in_ch=N_FRAMES * 3, num_out_ch=3, num_feat=8, num_block=1,
            num_grow_ch=4)
SRCNN_NET = dict(type="SRCNN", in_channels=3, mask_channels=0, hidden_channels=16, out_channels=3,
                 kernel_size=3, residual_layers=1, output_size=128, zoom_factor=4, sr_kernel_size=1)


def write_tile(tile_dir, rng, grid=16, frames=4):
    """A tile of grid x grid chunks, each [frames*32, 32, 3]; chunk (0, 1)
    has a black frame, which the good-first frame policy skips."""
    for i in range(grid):
        for j in range(grid):
            data = (rng.rand(frames * 32, 32, 3) * 254 + 1).astype(np.uint8)
            if (i, j) == (0, 1):
                data[32:40] = 0
            write_png(os.path.join(tile_dir, f"{i}_{j}.png"), data)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid")
    write_tile(str(root / "data" / "tile_a"), np.random.RandomState(0))
    return root


def weights(root, net):
    """A reference-format .pth from the JAX model's seeded init."""
    from satlas_sr_tpu.utils.model_utils import build_network

    path = str(root / f"{net['type']}.pth")
    if not os.path.exists(path):
        opt = {"n_lr_images": N_FRAMES, "scale": 4, "network_g": net}
        m = build_network(opt)
        x = (jnp.zeros((1, N_FRAMES, 32, 32, 3)) if net["type"] == "SRCNN"
             else jnp.zeros((1, 32, 32, N_FRAMES * 3)))
        v = jax.jit(m.init)(jax.random.PRNGKey(0), x)
        state = jax_torch_io.export_torch_state(net["type"], v)
        jax_torch_io.save_torch_state_dict(path, state, param_key="params_ema")
    return path


def grid_opt(root, save, net=RRDB, **mode):
    return {"data_dir": str(root / "data"), "save_path": str(root / save),
            "n_lr_images": N_FRAMES, "scale": 4, "grid_size": 16, "batch_size": 256,
            "compute_dtype": "float32", "matmul_precision": "highest", "network_g": net,
            "path": {"pretrain_network_g": weights(root, net), "param_key_g": "params_ema"},
            **mode}


def assert_close_levels(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def assert_stitched_match(port_dir, jax_dir):
    sr = read_png(os.path.join(port_dir, "tile_a", "stitched_sr.png"))
    assert sr.shape == (2048, 2048, 3)
    assert_close_levels(sr, read_png(os.path.join(jax_dir, "tile_a", "stitched_sr.png")))
    s2 = read_png(os.path.join(port_dir, "tile_a", "stitched_s2.png"))
    assert s2.shape == (512, 512, 3)
    np.testing.assert_array_equal(s2, read_png(os.path.join(jax_dir, "tile_a", "stitched_s2.png")))


def test_chunked_cli_matches_jax(tree):
    from satlas_sr_tpu.infer import run_inference as jax_run
    from satlas_sr_tpu.infer_grid import stitch_tiles as jax_stitch

    opt = grid_opt(tree, "jax_chunked")
    assert jax_run(opt, save_lr=False, grid_naming=True) == 256
    jax_stitch(opt["data_dir"], opt["save_path"])
    popt = grid_opt(tree, "port_chunked")
    path = tree / "chunked.yml"
    path.write_text(yaml.safe_dump(popt))
    port_grid.main(["-opt", str(path), "--device", "cpu"])
    assert sorted(os.listdir(tree / "port_chunked" / "tile_a")) == \
        sorted(os.listdir(tree / "jax_chunked" / "tile_a"))
    assert read_png(str(tree / "port_chunked" / "tile_a" / "3_4.png")).shape == (128, 128, 3)
    assert_stitched_match(tree / "port_chunked", tree / "jax_chunked")


@pytest.mark.parametrize("net", [RRDB, SRCNN_NET], ids=["rrdbnet", "srcnn"])
def test_whole_tile_matches_jax(tree, net):
    from satlas_sr_tpu.infer_grid import run_whole_tile as jax_whole

    name = f"whole_{net['type']}"
    assert jax_whole(grid_opt(tree, f"jax_{name}", net, whole_tile=True, batch_size=1,
                              spatial_shards=1)) == 1
    assert port_grid.run_grid(grid_opt(tree, f"port_{name}", net, whole_tile=True, batch_size=1,
                                       spatial_shards=1), device="cpu") == 1
    assert_stitched_match(tree / f"port_{name}", tree / f"jax_{name}")


def test_halo_matches_jax(tree):
    from satlas_sr_tpu.infer_grid import run_halo_tiles as jax_halo

    assert jax_halo(grid_opt(tree, "jax_halo", halo=6)) == 1
    assert port_grid.run_grid(grid_opt(tree, "port_halo", halo=6), device="cpu") == 1
    assert_stitched_match(tree / "port_halo", tree / "jax_halo")


def test_skip_existing_resume_and_mutated_corpus(tmp_path):
    """Chunked: only missing chunks are recomputed, bit-identically; whole
    tile: a stitched tile is skipped. A corpus changed other than by a tail
    append is refused until --force."""
    write_tile(str(tmp_path / "data" / "tile_a"), np.random.RandomState(1))
    opt = grid_opt(tmp_path, "out", skip_existing=True)
    assert port_grid.run_grid(opt, device="cpu") == 256
    chunk = tmp_path / "out" / "tile_a" / "5_7.png"
    full = read_png(str(chunk))
    os.remove(chunk)
    os.remove(tmp_path / "out" / "tile_a" / "stitched_sr.png")
    assert port_grid.run_grid(opt, device="cpu") == 1
    np.testing.assert_array_equal(read_png(str(chunk)), full)
    assert (tmp_path / "out" / "tile_a" / "stitched_sr.png").exists()

    whole = grid_opt(tmp_path, "out_whole", whole_tile=True, batch_size=1, skip_existing=True)
    assert port_grid.run_grid(whole, device="cpu") == 1
    assert port_grid.run_grid(whole, device="cpu") == 0

    os.remove(tmp_path / "data" / "tile_a" / "0_0.png")  # shifts every later index
    for o in (opt, whole):
        with pytest.raises(RuntimeError, match="corpus changed"):
            port_grid.run_grid(o, device="cpu")


def test_modes_refuse_what_they_do_not_take(tmp_path):
    opt = {"data_dir": str(tmp_path), "save_path": str(tmp_path / "o"), "n_lr_images": N_FRAMES,
           "scale": 4}
    with pytest.raises(ValueError, match="4-D conv families"):
        port_grid.run_grid({**opt, "halo": 6, "network_g": SRCNN_NET}, device="cpu")
    with pytest.raises(ValueError, match="must exceed"):
        port_grid.run_grid({**opt, "halo": 16, "network_g": RRDB}, device="cpu")
    with pytest.raises(ValueError, match="must divide the process count 1: start S ranks "
                                         "through --launcher"):
        port_grid.run_grid({**opt, "whole_tile": True, "spatial_shards": 2, "network_g": RRDB},
                           device="cpu")


def test_window_geometry_matches_jax():
    from satlas_sr_tpu.infer_grid import _responsibility, _window_starts

    for length, win, halo in ((512, 32, 6), (512, 32, 4), (64, 32, 6), (32, 32, 6)):
        starts = port_grid._window_starts(length, win, win - 2 * halo)
        assert starts == _window_starts(length, win, win - 2 * halo)
        owns = port_grid._responsibility(starts, win, length)
        assert owns == _responsibility(starts, win, length)
        assert owns[0][0] == 0 and owns[-1][1] == length

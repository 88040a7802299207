"""Every GT-free inference config under options/ runs through the port's CLI.

The 13 configs (infer_example.yml, infer_grid_{example,whole_tile,halo}.yml
and the nine zoo/infer_*.yml) are read as shipped; only data_dir,
save_path, the weights (a seeded .pth of the port's own model) and the
widths and depth change (RRDBNet nf 8, g 4, one block; SRCNN/HighResNet
hidden 16). Modes, dtypes, batch sizes, bands, frame counts and grid
options stay. Each runs on the CPU through `infer` or `infer_grid` on a
small synthetic corpus; the outputs have the configs' shapes.
"""

import glob
import os

import numpy as np
import pytest
import yaml

from satlas_sr_tpu_torch import infer, infer_grid
from satlas_sr_tpu_torch.utils.imgio import read_png, write_png
from satlas_sr_tpu_torch.utils.model_utils import build_network
from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "options", "infer*.yml"))
                 + glob.glob(os.path.join(ROOT, "options", "zoo", "infer_*.yml")))


def test_all_thirteen_configs_are_here():
    assert len(CONFIGS) == 13


def _shrink(net):
    if net["type"] == "SSR_RRDBNet":
        return {**net, "num_feat": 8, "num_grow_ch": 4, "num_block": 1}
    return {**net, "hidden_channels": 16}


@pytest.fixture(scope="module")
def grid_tile(tmp_path_factory):
    """One 16x16-chunk tile, 8 frames a chunk."""
    root = tmp_path_factory.mktemp("tile")
    rng = np.random.RandomState(0)
    for i in range(16):
        for j in range(16):
            write_png(str(root / "tile_a" / f"{i}_{j}.png"),
                      (rng.rand(8 * 32, 32, 3) * 254 + 1).astype(np.uint8))
    return str(root)


def _chips(root, opt, rng, n=2):
    frames = int(opt["n_lr_images"]) + 1
    for c in range(n):
        tci = (rng.rand(frames * 32, 32, 3) * 254 + 1).astype(np.uint8)
        if opt.get("s2_bands"):
            write_png(os.path.join(root, f"chip{c}", "tci.png"), tci)
            for band in opt["s2_bands"][1:-1]:  # the last band is left missing: zero-filled
                write_png(os.path.join(root, f"chip{c}", f"{band}.png"),
                          (rng.rand(frames * 32, 32, 1) * 255).astype(np.uint8))
        else:
            write_png(os.path.join(root, f"chip{c}.png"), tci)
    return root


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, os.path.join(ROOT, "options")))
def test_config_runs_on_the_port(tmp_path, grid_tile, path):
    with open(path) as f:
        opt = yaml.safe_load(f)
    grid = os.path.basename(path).startswith("infer_grid")
    opt["network_g"] = _shrink(opt["network_g"])
    opt["save_path"] = str(tmp_path / "out")
    opt["data_dir"] = grid_tile if grid else _chips(str(tmp_path / "data"), opt,
                                                    np.random.RandomState(1))
    weights = str(tmp_path / "net_g.pth")
    save_torch_state_dict(weights, build_network(opt, device="cpu").state_dict(), "params_ema")
    opt["path"]["pretrain_network_g"] = weights
    opt_path = tmp_path / "opt.yml"
    opt_path.write_text(yaml.safe_dump(opt))

    if grid:
        infer_grid.main(["-opt", str(opt_path), "--device", "cpu"])
        assert read_png(str(tmp_path / "out" / "tile_a" / "stitched_sr.png")).shape == (2048, 2048, 3)
        assert read_png(str(tmp_path / "out" / "tile_a" / "stitched_s2.png")).shape == (512, 512, 3)
    else:
        infer.main(["-opt", str(opt_path), "--device", "cpu"])
        for c in range(2):
            assert read_png(str(tmp_path / "out" / str(c) / "sr.png")).shape == (128, 128, 3)
            assert read_png(str(tmp_path / "out" / str(c) / "lr.png")).shape == (32, 32, 3)

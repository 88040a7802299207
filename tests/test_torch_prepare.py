"""The port's host tools, on the CPU, against the JAX package's:
`prepare` (satlas_sr_tpu_torch.prepare; satlas_sr_tpu.prepare) and the tower
dry-run (satlas_sr_tpu_torch.tower_dryrun; scripts/tower_dryrun.py).

- prepare: the grid constants, `tile_of` / `tile_origin`, `covered_tiles`,
  `snap_to_grid` and `normalize_band` equal JAX's on seeded values;
  `chip_raster` on a seeded S2 raster (tci and a 16-bit band, two revisits
  appended) and a NAIP raster writes the same files, tile ids and summary
  as JAX's, with the same pixels (the PNG bytes differ: the port encodes
  with its own zlib codec); `reproject` without rasterio refuses with the
  JAX tool's message and recipe; the CLI's chips load through the port's
  S2-NAIP dataset.
- tower_dryrun: on tests/test_tower_dryrun.py's fixtures (one file of each
  family) and a junk file, the per-file classification, imported flags,
  parameter counts, report keys and exit codes equal the JAX script's;
  the LPIPS fingerprints within 1e-5 and the forward fingerprints' mean
  and std within 1e-4 of JAX's.
"""

import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import satlas_sr_tpu.prepare as jax_prepare
from satlas_sr_tpu_torch import prepare, tower_dryrun
from satlas_sr_tpu_torch.data import build_dataset
from satlas_sr_tpu_torch.utils.imgio import read_png, write_png
from test_tower_dryrun import _vgg19_state
from test_tower_import import _lpips_state, _openai_state
from torch_threads import two_torch_threads  # noqa: F401

ORIGIN = prepare.tile_origin(1000, 2000)


def test_tile_math_equals_jax(rng):
    for name in ("WEB_MERCATOR_E", "GRID", "TILE_M", "S2_CHIP", "NAIP_CHIP", "S2_RES",
                 "NAIP_RES", "S2_BANDS"):
        assert getattr(prepare, name) == getattr(jax_prepare, name), name
    pts = (rng.rand(50, 2) * 2 - 1) * prepare.WEB_MERCATOR_E
    for x, y in pts:
        assert prepare.tile_of(x, y) == jax_prepare.tile_of(x, y)
        col, row = prepare.tile_of(x, y)
        assert prepare.tile_origin(col, row) == jax_prepare.tile_origin(col, row)
    for res, (w, h) in ((prepare.S2_RES, (70, 40)), (prepare.NAIP_RES, (300, 130))):
        assert prepare.covered_tiles(ORIGIN, (h, w), res) == jax_prepare.covered_tiles(
            ORIGIN, (h, w), res)
        for ox, oy in pts[:10]:
            assert prepare.snap_to_grid(ox, oy, w, h, res) == jax_prepare.snap_to_grid(
                ox, oy, w, h, res)
    for band, arr in (("tci", rng.rand(4, 4, 3) * 255), ("b08", rng.rand(4, 4, 1) * 9000),
                      ("rgb", (rng.rand(4, 4, 3) * 255).astype(np.uint8))):
        assert np.array_equal(prepare.normalize_band(arr, band),
                              jax_prepare.normalize_band(arr, band))


def _chip_both(tmp_path, rasters):
    """Run each (arr, role, band) through both tools into their own roots;
    -> (port summaries, jax summaries, port root, jax root)."""
    roots = {name: str(tmp_path / name) for name in ("port", "jax")}
    got, want = [], []
    for arr, role, band in rasters:
        res = prepare.S2_RES if role == "s2" else prepare.NAIP_RES
        got.append(prepare.chip_raster(arr, ORIGIN, res, roots["port"], role, band=band))
        want.append(jax_prepare.chip_raster(arr, ORIGIN, res, roots["jax"], role, band=band))
    return got, want, roots["port"], roots["jax"]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_chips_equal_jax(tmp_path, rng):
    s2 = lambda c, scale: (rng.rand(prepare.S2_CHIP, 2 * prepare.S2_CHIP + 7, c) * scale)
    rasters = [(s2(3, 255).astype(np.uint8), "s2", "tci"), (s2(3, 255).astype(np.uint8), "s2", "tci"),
               (s2(1, 12000), "s2", "b08"),
               ((rng.rand(prepare.NAIP_CHIP, 2 * prepare.NAIP_CHIP, 3) * 255).astype(np.uint8),
                "naip", "rgb")]
    rasters[0][0][:, :prepare.S2_CHIP] = 0  # a nodata tile: skipped
    got, want, port_root, jax_root = _chip_both(tmp_path, rasters)
    assert got == want
    assert got[0]["skipped_blank"] == 1 and got[1]["appended"] == 1
    assert _files(port_root) == _files(jax_root) and _files(port_root)
    for rel in _files(port_root):
        a, b = read_png(os.path.join(port_root, rel)), read_png(os.path.join(jax_root, rel))
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b), rel


@pytest.mark.skipif(importlib.util.find_spec("rasterio") is not None,
                    reason="rasterio installed; refusal path not reachable")
def test_reproject_refuses_without_rasterio_as_jax(tmp_path):
    msgs = []
    for module in (prepare, jax_prepare):
        with pytest.raises(SystemExit) as e:
            module.reproject_raster("src.jp2", str(tmp_path / "out.tif"), prepare.S2_RES)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "Resampling.bilinear" in msgs[0] and "9.554628536" in msgs[0]


def test_cli_chips_load_through_the_port_dataset(tmp_path, rng, capsys):
    ox, oy = ORIGIN
    data = tmp_path / "root"
    for i in range(2):
        p = tmp_path / f"s2_{i}.png"
        write_png(str(p), (rng.rand(prepare.S2_CHIP, 2 * prepare.S2_CHIP, 3) * 254 + 1)
                  .astype(np.uint8))
        assert prepare.main(["chip", "--input", str(p), "--out", str(data),
                             f"--origin={ox},{oy}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tiles"] == 2 and out["appended"] == 2
    p = tmp_path / "naip.png"
    write_png(str(p), (rng.rand(prepare.NAIP_CHIP, 2 * prepare.NAIP_CHIP, 3) * 254 + 1)
              .astype(np.uint8))
    assert prepare.main(["chip", "--input", str(p), "--out", str(data), "--role", "naip",
                         f"--origin={ox},{oy}", "--uuid", "m_20190601"]) == 0
    ds = build_dataset({"name": "prepared", "type": "S2NAIPDataset", "phase": "train",
                        "n_s2_images": 2, "scale": 4, "sentinel2_path": str(data / "sentinel2"),
                        "naip_path": str(data / "naip")})
    assert len(ds) == 2
    item = ds[0]
    assert item["lr"].shape == (prepare.S2_CHIP, prepare.S2_CHIP, 6)
    assert item["hr"].shape == (prepare.NAIP_CHIP, prepare.NAIP_CHIP, 3)
    assert item["Chip"] in ("1000_2000", "1001_2000")
    with pytest.raises(SystemExit, match="--origin"):
        prepare.main(["chip", "--input", str(p), "--out", str(tmp_path / "d")])


# -- tower dry-run ---------------------------------------------------------------

_SPEC = importlib.util.spec_from_file_location(
    "jax_tower_dryrun", os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                                     "tower_dryrun.py"))
jax_dryrun = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_dryrun)


def _both(monkeypatch, tmp_path, weights, *extra):
    """(port rc, report), (JAX rc, report) of one dry run each."""
    out = []
    for name in ("port", "jax"):
        path = tmp_path / f"{name}.json"
        argv = [str(weights), "--clip-models", "test-tiny-openai", "--out", str(path), *extra]
        if name == "port":
            rc = tower_dryrun.main(argv + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["tower_dryrun.py"] + argv)
            rc = jax_dryrun.main()
        out.append((rc, json.loads(path.read_text())))
    return out


def _numbers(fingerprint):
    return [float(v) for v in re.findall(r"[-+]?\d+\.\d+", fingerprint.split(" ", 1)[-1])]


def test_dryrun_classification_equals_the_jax_script(tmp_path, rng, monkeypatch):
    d = tmp_path / "weights"
    d.mkdir()
    torch.save(_vgg19_state(rng), str(d / "vgg19.pth"))
    torch.save(_lpips_state(rng, "vgg"), str(d / "lpips_vgg.pth"))
    torch.save(_lpips_state(rng, "alex"), str(d / "lpips_alex.pth"))
    torch.save(_openai_state(rng), str(d / "clip_vitb.pth"))
    torch.save({"mystery.weight": torch.zeros(3, 3)}, str(d / "junk.pth"))
    (rc, got), (jax_rc, want) = _both(monkeypatch, tmp_path, d)
    assert rc == jax_rc == 2 and got.keys() == want.keys()
    assert got["all_imported"] is want["all_imported"] is False
    assert [r["file"] for r in got["files"]] == [r["file"] for r in want["files"]]
    for g, w in zip(got["files"], want["files"]):
        assert g["imported"] == w["imported"], g["file"]
        assert [(m["tower"], m.get("n_params"), "error" in m) for m in g["matches"]] == [
            (m["tower"], m.get("n_params"), "error" in m) for m in w["matches"]], g["file"]
        for gm, wm in zip(g["matches"], w["matches"]):
            a, b = _numbers(gm["fingerprint"]), _numbers(wm["fingerprint"])
            tol = 1e-5 if gm["tower"].startswith("lpips") else 1e-4
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=g["file"])
    imported = {r["file"]: {m["tower"] for m in r["matches"]} for r in got["files"]}
    assert imported["lpips_alex.pth"] == {"lpips-alex"}
    assert imported["clip_vitb.pth"] == {"clip:test-tiny-openai"}
    assert "vgg19" in imported["vgg19.pth"] and imported["junk.pth"] == set()
    os.remove(d / "junk.pth")
    (rc, got), (jax_rc, want) = _both(monkeypatch, tmp_path, d, "--max-forward-params", "1")
    assert rc == jax_rc == 0
    fps = [m["fingerprint"] for r in got["files"] for m in r["matches"]]
    assert fps and all(fp.startswith("params:") for fp in fps)

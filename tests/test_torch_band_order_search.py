"""The port's band-order search (satlas_sr_tpu_torch/band_order_search.py)
against the JAX package's scripts/band_order_search.py, on the CPU:

- `enumerate_orders` equals JAX's on every case of tests/test_band_order_search.py,
  the `--bands` refusal included;
- on the JAX test's construction (a seeded nf-8, one-block generator whose
  own SR of the true stacking is the NAIP GT) the port's search ranks the
  true order first by > 3 dB and prints its `s2_bands:` line;
- on a tree whose GT is that SR moved by a seeded -2..2 levels (every
  candidate's PSNR finite), each candidate's PSNR is within 0.01 dB of the
  JAX script's `main` on the same .pth and tree (float32, its
  `highest` matmul precision; the port's TF32 is off).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from satlas_sr_tpu_torch import band_order_search as bos
from satlas_sr_tpu_torch.archs import RRDBNet
from satlas_sr_tpu_torch.utils.imgio import write_png
from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict
from torch_threads import two_torch_threads  # noqa: F401

_SPEC = importlib.util.spec_from_file_location(
    "jax_band_order_search", os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                                          "band_order_search.py"))
jax_bos = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_bos)

N_FRAMES, TRUE_BANDS, CPF = 2, ["tci", "b05", "b06"], 5
ORDER_CASES = [(["tci", "b05", "b06", "b07"], 5, 1000), (["b05", "b06", "b07"], 3, 1000),
               (["tci", "b08"], 4, 1000), (["tci", "b08", "b05", "b06"], 4, 1000),
               ([f"b{i:02d}" for i in range(8)], 5, 10)]


def _orders(module, available, cpf, cap):
    try:
        return module.enumerate_orders(available, cpf, max_candidates=cap)
    except ValueError as e:
        return ("ValueError", "--bands" in str(e))


@pytest.mark.parametrize("available,cpf,cap", ORDER_CASES)
def test_enumerate_orders_equals_jax(available, cpf, cap):
    got = _orders(bos, available, cpf, cap)
    assert got == _orders(jax_bos, available, cpf, cap)
    if cap == 10:
        assert got == ("ValueError", True)


def _tree(tmp_path, dither: bool):
    """(the .pth, the val root): 4 chips of tci/b05/b06 frames, the NAIP GT
    the generator's SR of the true stacking (moved by a seeded -2..2 levels
    with `dither`)."""
    model = RRDBNet(num_in_ch=N_FRAMES * CPF, num_out_ch=3, num_feat=8, num_block=1,
                    num_grow_ch=4, seed=3, device="cpu")
    pth = str(tmp_path / "esrgan_synth.pth")
    save_torch_state_dict(pth, model.state_dict(), param_key="params_ema")
    rng = np.random.RandomState(0)
    root = tmp_path / "val"
    for c in range(4):
        chip = f"{700 + c}_{800 + c}"
        per_band = {}
        for band in TRUE_BANDS:
            ch = 3 if band == "tci" else 1
            img = (rng.rand(N_FRAMES * 32, 32, ch) * 254 + 1).astype(np.uint8)
            write_png(str(root / "sentinel2" / chip / f"{band}.png"), img)
            per_band[band] = img.reshape(N_FRAMES, 32, 32, -1)
        stack = np.concatenate([per_band[b] for b in TRUE_BANDS], axis=-1)
        hr = bos.super_resolve(model, np.concatenate(list(stack), axis=-1)[None], "cpu")[0]
        if dither:
            hr = np.clip(hr.astype(np.int64) + rng.randint(-2, 3, hr.shape), 0, 255)
        write_png(str(root / "naip" / chip / f"{chip}.png"), hr.astype(np.uint8))
    return pth, str(root)


def test_search_recovers_true_band_order(tmp_path, capsys):
    pth, root = _tree(tmp_path, dither=False)
    out = tmp_path / "report.json"
    assert bos.main([pth, root, "--n-frames", str(N_FRAMES), "--limit", "3", "--out", str(out),
                     "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert report["winner"] == TRUE_BANDS
    assert report["margin_db"] > 3.0
    assert report["ranking"][0]["psnr"] > report["ranking"][1]["psnr"]
    assert {tuple(r["bands"]) for r in report["ranking"]} == {("tci", "b05", "b06"),
                                                             ("tci", "b06", "b05")}
    assert "s2_bands: [tci, b05, b06]" in capsys.readouterr().out


def test_ranking_within_001_db_of_the_jax_script(tmp_path, monkeypatch):
    pth, root = _tree(tmp_path, dither=True)
    want_path, got_path = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["band_order_search.py", pth, root, "--n-frames",
                                      str(N_FRAMES), "--out", str(want_path)])
    assert jax_bos.main() == 0
    assert bos.main([pth, root, "--n-frames", str(N_FRAMES), "--out", str(got_path),
                     "--device", "cpu"]) == 0
    want, got = json.loads(want_path.read_text()), json.loads(got_path.read_text())
    assert got["winner"] == want["winner"] == TRUE_BANDS
    assert got["margin_db"] > 3.0
    want_psnr = {tuple(r["bands"]): r["psnr"] for r in want["ranking"]}
    got_psnr = {tuple(r["bands"]): r["psnr"] for r in got["ranking"]}
    assert got_psnr.keys() == want_psnr.keys()
    for bands, psnr in want_psnr.items():
        assert np.isfinite(psnr) and abs(got_psnr[bands] - psnr) <= 0.01, bands
    assert [r["chips"] for r in got["ranking"]] == [r["chips"] for r in want["ranking"]]

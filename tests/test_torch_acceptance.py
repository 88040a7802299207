"""The port's acceptance command against the JAX package's, the slice as a whole.

Both `satlas_sr_tpu.acceptance` and `satlas_sr_tpu_torch.acceptance` (on
the CPU, device="cpu") run on the same tiny reference-format .pth (nf 8,
one block, g 4; the port's seeded weights) and the same tiny val tree (2
frames). Held: the exit codes, `pass`, the stage names and their `ok`; the
preflight's arch dict; the oracle path's metrics equal (the same torch
oracle on the same inputs); the framework-under-test's PSNR and cPSNR within
1e-4 dB and SSIM within 1e-6; the forward max|d| within the 1e-4 bar on
both. Cases: a pass through the registry and a local HTTP server (the fetch
stage), a parity failure (exit 2: an impossible forward tolerance), a
blocked fetch (exit 3), a checkpoint of no released family (exit 2), an
SRCNN checkpoint (the L2 family), and the informational bf16 leg's error.
"""

import json

import numpy as np
import pytest
import torch

from satlas_sr_tpu import acceptance as jax_acceptance, fetch as jax_fetch
from satlas_sr_tpu_torch import acceptance, fetch
from satlas_sr_tpu_torch.archs import SRCNN, RRDBNet
from satlas_sr_tpu_torch.utils.imgio import write_png
from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict

from test_acceptance import _tar_bytes
from test_fetch import _url, http_server  # noqa: F401 - the local server fixture
from torch_threads import two_torch_threads  # noqa: F401

TINY_CLIP = ["--clip-model", "test-tiny"]  # no pretrained tower: the CLIP leg is skipped


def _val_tree(root, rng, chips=3, frames=2):
    for c in range(chips):
        chip = f"{500 + c}_{600 + c}"
        write_png(str(root / "naip" / chip / f"{chip}.png"),
                  (rng.rand(128, 128, 3) * 254 + 1).astype(np.uint8))
        write_png(str(root / "sentinel2" / chip / "tci.png"),
                  (rng.rand(frames * 32, 32, 3) * 254 + 1).astype(np.uint8))
    return root


@pytest.fixture
def artifacts(tmp_path, rng):
    pth = tmp_path / "esrgan_8S2.pth"
    model = RRDBNet(num_in_ch=6, num_out_ch=3, num_feat=8, num_block=1, num_grow_ch=4, seed=3,
                    device="cpu")
    save_torch_state_dict(str(pth), model.state_dict(), param_key="params_ema")
    return {"tree": _val_tree(tmp_path / "tree", rng), "pth": pth}


def _both(tmp_path, argv, port_argv=()):
    """Run both commands; returns ((rc, verdict) JAX, (rc, verdict) port)."""
    out = []
    for name, mod, extra in (("jax", jax_acceptance, ()),
                             ("port", acceptance, ("--device", "cpu", *port_argv))):
        path = tmp_path / f"{name}.json"
        rc = mod.main([*argv, "--workdir", str(tmp_path / f"ws_{name}"), "--out", str(path),
                       *TINY_CLIP, *extra])
        out.append((rc, json.loads(path.read_text())))
    return out


def _same_verdict(jax_run, port_run):
    (rc_j, v_j), (rc_p, v_p) = jax_run, port_run
    assert rc_p == rc_j
    assert v_p["pass"] == v_j["pass"] and v_p.get("blocked") == v_j.get("blocked")
    assert {k: s["ok"] for k, s in v_p["stages"].items()} == \
        {k: s["ok"] for k, s in v_j["stages"].items()}
    if "preflight" in v_j["stages"] and "arch" in v_j["stages"]["preflight"]:
        assert v_p["stages"]["preflight"]["arch"] == v_j["stages"]["preflight"]["arch"]
    assert v_p["command"] == "satlas_sr_tpu_torch.acceptance" and v_p["device"] == "cpu"


def _same_metrics(v_j, v_p):
    ev_j, ev_p = v_j["stages"]["evaluate"], v_p["stages"]["evaluate"]
    assert ev_p["images_evaluated"] == ev_j["images_evaluated"]
    assert ev_p["metrics"]["torch_oracle"] == ev_j["metrics"]["torch_oracle"]
    for m, tol in (("psnr", 1e-4), ("cpsnr", 1e-4), ("ssim", 1e-6)):
        assert abs(ev_p["metrics"]["jax"][m] - ev_j["metrics"]["jax"][m]) <= tol, m
    assert "skipped" in ev_p["clipscore"] and "delta_clipscore" not in ev_p
    for v in (v_j, v_p):
        assert v["stages"]["forward"]["max_abs_diff"] <= 1e-4


def test_pass_through_the_registry(http_server, tmp_path, monkeypatch, artifacts):  # noqa: F811
    http_server.files["/esrgan_8S2.pth"] = artifacts["pth"].read_bytes()
    http_server.files["/small_val.tar"] = _tar_bytes(str(artifacts["tree"]), "small_val_set")
    for reg in (jax_fetch.REGISTRY, fetch.REGISTRY):
        monkeypatch.setitem(reg, "esrgan_8S2", {
            "urls": [_url(http_server, "/esrgan_8S2.pth")], "kind": "file", "about": "t"})
        monkeypatch.setitem(reg, "small_val_set", {
            "urls": [_url(http_server, "/small_val.tar")], "kind": "tar", "about": "t"})
    jax_run, port_run = _both(tmp_path, ["--limit", "2", "--batch-size", "2"])
    _same_verdict(jax_run, port_run)
    (rc, v_j), (_, v_p) = jax_run, port_run
    assert rc == 0 and v_p["pass"] is True
    assert set(v_p["stages"]) == {"fetch", "preflight", "forward", "evaluate", "bf16_engine"}
    _same_metrics(v_j, v_p)
    prod_j, prod_p = v_j["stages"]["bf16_engine"], v_p["stages"]["bf16_engine"]
    for m in ("psnr", "cpsnr"):  # the float32 engine control, to 1e-4 dB
        assert abs(prod_p["metrics"]["f32_engine"][m] - prod_j["metrics"]["f32_engine"][m]) <= 1e-4
    assert prod_p["bf16_within_bar"] == (prod_p["at_parity_engine"] == "bfloat16")
    assert v_p["at_parity_engine"] == prod_p["at_parity_engine"]
    assert (tmp_path / "ws_port" / "weights" / "esrgan_8S2.pth").exists()
    assert (tmp_path / "ws_port" / "data" / "small_val_set" / "naip").is_dir()


def test_parity_failure_exits_2(tmp_path, artifacts):
    """An impossible forward tolerance (the port's CPU forward can equal the
    oracle's exactly, so the bar is below zero): FAIL, exit 2, stopped there."""
    jax_run, port_run = _both(tmp_path, ["--weights", str(artifacts["pth"]), "--data",
                                         str(artifacts["tree"]), "--fwd-tol", "-1",
                                         "--limit", "2"])
    _same_verdict(jax_run, port_run)
    assert port_run[0] == 2 and "evaluate" not in port_run[1]["stages"]


def test_blocked_fetch_exits_3(tmp_path, monkeypatch):
    for reg in (jax_fetch.REGISTRY, fetch.REGISTRY):
        monkeypatch.setitem(reg, "esrgan_8S2", {
            "urls": ["http://127.0.0.1:9/unreachable.pth"], "kind": "file", "about": "t"})
    jax_run, port_run = _both(tmp_path, [])
    _same_verdict(jax_run, port_run)
    assert port_run[0] == 3 and port_run[1]["stages"]["fetch"]["blocked"] is True


def test_no_released_family_exits_2(tmp_path, artifacts):
    bad = tmp_path / "not_esrgan.pth"
    torch.save({"params_ema": {"something.weight": torch.zeros(1)}}, str(bad))
    jax_run, port_run = _both(tmp_path, ["--weights", str(bad), "--data",
                                         str(artifacts["tree"])])
    _same_verdict(jax_run, port_run)
    assert "no released generator family" in port_run[1]["stages"]["preflight"]["error"]


def test_srcnn_family(tmp_path, artifacts):
    pth = tmp_path / "srcnn_s2naip.pth"
    model = SRCNN(in_channels=3, revisits=2, hidden_channels=16, out_channels=3,
                  residual_layers=1, output_size=128, zoom_factor=4, sr_kernel_size=1, seed=5,
                  device="cpu")
    save_torch_state_dict(str(pth), model.state_dict(), param_key="params_ema")
    jax_run, port_run = _both(tmp_path, ["--weights", str(pth), "--data", str(artifacts["tree"]),
                                         "--n-frames-hint", "2", "--limit", "2",
                                         "--batch-size", "2"])
    _same_verdict(jax_run, port_run)
    assert port_run[0] == 0
    arch = port_run[1]["stages"]["preflight"]["arch"]
    assert arch["family"] == "srcnn" and arch["revisits"] == 2 and arch["residual_layers"] == 1
    _same_metrics(jax_run[1], port_run[1])


def test_bf16_leg_error_is_informational(tmp_path, artifacts, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no memory for a second engine")

    monkeypatch.setattr(acceptance, "_production_engine_eval", boom)
    out = tmp_path / "v.json"
    rc = acceptance.main(["--weights", str(artifacts["pth"]), "--data", str(artifacts["tree"]),
                          "--workdir", str(tmp_path / "ws"), "--out", str(out), "--limit", "2",
                          "--device", "cpu", *TINY_CLIP])
    verdict = json.loads(out.read_text())
    assert rc == 0 and verdict["pass"] is True
    leg = verdict["stages"]["bf16_engine"]
    assert leg["ok"] is False and leg["informational"] is True and "no memory" in leg["error"]
    assert verdict["at_parity_engine"] == "float32_highest"


def test_cuda_without_a_card_raises(tmp_path, artifacts):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        acceptance.main(["--weights", str(artifacts["pth"]), "--data", str(artifacts["tree"]),
                         "--out", str(tmp_path / "v.json")])
    assert not (tmp_path / "v.json").exists()

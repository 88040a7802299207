"""The port's run tooling on the CPU, against the JAX package's tools.

- fetch: the port's REGISTRY equals the JAX package's; download, resume,
  retry, the 416 self-heal, sha256, the tar refusals, multi-part artifacts,
  --url and --no-download against a local HTTP server (tests/test_fetch.py's).
- ckpt: on one .pth the port's report equals the JAX `inspect` report's
  format, status, collections and leaves; a port .state is read with its
  step; a flipped byte is CORRUPT (exit 1); .msgpack and orbax roots exit 1
  naming their ROADMAP items.
- scan_data: on one tree with each kind of bad chip the port's report equals
  the JAX `scan_dataset` report, key for key.
- doctor: on every shipped options/**/*.yml the port's rows in the schema,
  config, filesystem, consistency and tower areas equal the JAX doctor's
  (the `perf` pointer differs on purpose: the JAX one quotes TPU figures);
  the runtime leg with device="cpu" and without a card.
- warmup: `_synth_batch` equals the JAX package's array for array on every
  shipped train config; a narrowed train config and an infer config warm
  up on the CPU.
- profile: infer and train modes on the CPU print the CPU-op summary and
  write the Chrome trace.
"""

import glob
import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch
import yaml

from satlas_sr_tpu import ckpt as jax_ckpt, doctor as jax_doctor, fetch as jax_fetch
from satlas_sr_tpu import scan_data as jax_scan, warmup as jax_warmup
from satlas_sr_tpu.data.loader import build_dataset as jax_build_dataset
from satlas_sr_tpu_torch import ckpt, doctor, fetch, profile, scan_data, warmup
from satlas_sr_tpu_torch.archs import RRDBNet
from satlas_sr_tpu_torch.data.loader import build_dataset
from satlas_sr_tpu_torch.utils.checkpoint import save_state
from satlas_sr_tpu_torch.utils.imgio import write_png
from satlas_sr_tpu_torch.utils.options import yaml_load
from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict

from test_fetch import _url, http_server  # noqa: F401 - the local server fixture
from test_torch_train_cli import make_tree, shipped, write
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YMLS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "options", "**", "*.yml"),
                                                          recursive=True))
TRAIN_YMLS = [p for p in YMLS if yaml_load(os.path.join(ROOT, p)).get("model_type")]


# ------------------------------------------------------------------- fetch


def _tar(members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            if data is None:  # a link member
                info.type, info.linkname = tarfile.SYMTYPE, "/etc/passwd"
                tf.addfile(info)
            else:
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_fetch_registry_equals_jax():
    assert fetch.REGISTRY == jax_fetch.REGISTRY


@pytest.mark.parametrize("case", ["full", "resume", "ignored_range", "short_read", "part_416",
                                  "missing"])
def test_fetch_download(http_server, tmp_path, case):  # noqa: F811
    body = os.urandom(150_000)
    http_server.files["/a.bin"] = body
    dest = str(tmp_path / "a.bin")
    naps = []
    if case == "resume":
        open(dest + ".part", "wb").write(body[:51_000])
    elif case == "ignored_range":
        http_server.ignore_range = True
        open(dest + ".part", "wb").write(b"\xff" * 40_000)
    elif case == "short_read":
        http_server.lie_length = 500
    elif case == "part_416":
        open(dest + ".part", "wb").write(body)
    if case == "missing":
        with pytest.raises(OSError, match="/gone.bin"):
            fetch.download(_url(http_server, "/gone.bin"), dest, retries=2, progress=False,
                           _sleep=naps.append)
        assert naps == [1.0]  # bounded retry with backoff
        return
    out = fetch.download(_url(http_server, "/a.bin"), dest, retries=2, progress=False,
                         _sleep=naps.append)
    assert out == dest and open(dest, "rb").read() == body
    assert not os.path.exists(dest + ".part")
    if case == "resume":
        assert http_server.requests[0].get("Range") == "bytes=51000-"
    if case == "short_read":
        assert len(naps) == 1
    n = len(http_server.requests)
    fetch.download(_url(http_server, "/a.bin"), dest, progress=False)  # complete: no request
    assert len(http_server.requests) == n


@pytest.mark.parametrize("members,match", [({"../evil.txt": b"x"}, "traversal"),
                                           ({"/abs.txt": b"x"}, "traversal"),
                                           ({"link": None}, "link member")])
def test_fetch_safe_extract_refuses(tmp_path, members, match):
    tar = tmp_path / "evil.tar"
    tar.write_bytes(_tar(members))
    with pytest.raises(ValueError, match=match):
        fetch.safe_extract_tar(str(tar), str(tmp_path / "out"))
    assert not (tmp_path / "evil.txt").exists()


def test_fetch_artifacts(http_server, tmp_path, monkeypatch, capsys):  # noqa: F811
    http_server.files["/val.tar"] = _tar({"val_set/naip/c/img.png": b"v1"})
    http_server.files["/w.pth"] = b"weights"
    for i in (1, 2):
        http_server.files[f"/t.7z.{i:03d}"] = f"part{i}".encode()
    reg = {"val_set": {"urls": [_url(http_server, "/val.tar")], "kind": "tar", "about": "t"},
           "esrgan_8S2": {"urls": ["https://unused.example/esrgan_8S2.pth"], "kind": "file",
                          "about": "t"},
           "train_urban_set": {"urls": [_url(http_server, f"/t.7z.{i:03d}") for i in (1, 2)],
                               "kind": "7z", "about": "t"}}
    for k, v in reg.items():
        monkeypatch.setitem(fetch.REGISTRY, k, v)
    fetch.fetch_artifact("val_set", str(tmp_path), progress=False)
    extracted = tmp_path / "val_set/naip/c/img.png"
    assert extracted.read_bytes() == b"v1"
    extracted.write_bytes(b"user")
    fetch.fetch_artifact("val_set", str(tmp_path), progress=False)  # marker: not re-extracted
    assert extracted.read_bytes() == b"user" and "already extracted" in capsys.readouterr().out
    signed = _url(http_server, "/w.pth") + "?X-Sig=SECRET"
    assert fetch.fetch_artifact("esrgan_8S2", str(tmp_path), url=signed, progress=False) == [
        str(tmp_path / "w.pth")]
    assert not any("SECRET" in n for n in os.listdir(tmp_path))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        fetch.fetch_artifact("esrgan_8S2", str(tmp_path), url=signed, sha256="0" * 64,
                             progress=False)
    good = fetch.sha256_file(str(tmp_path / "w.pth"))
    fetch.fetch_artifact("esrgan_8S2", str(tmp_path), url=signed, sha256=good.upper(),
                         progress=False)
    paths = fetch.fetch_artifact("train_urban_set", str(tmp_path), progress=False)
    assert [os.path.basename(p) for p in paths] == ["t.7z.001", "t.7z.002"]
    with pytest.raises(ValueError, match="2-part"):
        fetch.fetch_artifact("train_urban_set", str(tmp_path), url=signed)
    with pytest.raises(FileNotFoundError, match="mirror it in"):
        fetch.fetch_artifact("esrgan_8S2", str(tmp_path / "none"), no_download=True)
    assert fetch.main(["list"]) == 0 and "[2 parts]" in capsys.readouterr().out
    assert fetch.main(["get", "bogus", "--dest", str(tmp_path)]) == 1
    assert "unknown artifact" in capsys.readouterr().err


# -------------------------------------------------------------------- ckpt


def _small_pth(path, seed=0):
    m = RRDBNet(num_in_ch=6, num_out_ch=3, num_feat=8, num_block=1, num_grow_ch=4, seed=seed,
                device="cpu")
    sd = m.state_dict()
    torch.save({"params": sd, "params_ema": {k: v + 1 for k, v in sd.items()}}, str(path))
    return str(path)


def test_ckpt_pth_report_equals_jax(tmp_path):
    p = _small_pth(tmp_path / "net_g.pth")
    got, want = ckpt.inspect(p), jax_ckpt.inspect(p)
    for key in ("format", "status", "param_keys", "size_bytes", "collections", "leaves"):
        assert got[key] == want[key], key
    assert got["collections"]["params"]["tensors"] == len(torch.load(p)["params"])
    assert ckpt.main([p, "--json"]) == 0


def test_ckpt_state_and_corruption(tmp_path, capsys):
    p = str(tmp_path / "4.state")
    save_state(p, {"epoch": 1, "iter": 4, "state": {
        "step": 4, "g": {"params": {"w": torch.zeros(2, 3)},
                         "opt": {"state": {0: {"exp_avg": torch.ones(2, 3, dtype=torch.bfloat16)}},
                                 "param_groups": [{"lr": 1e-4, "params": [0]}]}}}})
    info = ckpt.inspect(p)
    assert info["status"] == "ok" and info["step"] == 4 and info["epoch"] == 1
    assert info["collections"]["g"]["params"] == 6 + 6 + 1 + 1
    leaf = [l for l in info["leaves"] if l["path"] == "g.opt.state.0.exp_avg"]
    assert leaf == [{"path": "g.opt.state.0.exp_avg", "shape": [2, 3], "dtype": "bfloat16"}]
    assert ckpt.main([p, "--full"]) == 0
    blob = bytearray(open(p, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    assert ckpt.inspect(p)["status"] == "CORRUPT"
    assert ckpt.main([p]) == 1 and "crc mismatch" in capsys.readouterr().out


def test_ckpt_unsupported_formats_name_their_items(tmp_path, capsys):
    """JAX-written .msgpack weights and msgpack .state files (once
    UNSUPPORTED) are read: their reports equal the JAX ckpt's, and a flipped
    byte is CORRUPT. An orbax root (once UNSUPPORTED, naming item 14) the
    port wrote (torch.distributed.checkpoint steps) reports ok with its
    steps and payload; one the JAX package wrote (orbax/tensorstore) stays
    UNSUPPORTED, naming the .state route the port reads instead."""
    from satlas_sr_tpu.utils.orbax_io import OrbaxCheckpointIO as JaxOrbaxIO
    from satlas_sr_tpu_torch.utils.orbax_io import OrbaxCheckpointIO
    from satlas_sr_tpu.utils.checkpoint import save_pytree

    jax_state = str(tmp_path / "3.state")
    save_pytree(jax_state, {"epoch": 1, "iter": 3, "state": {"step": np.int32(3)}})
    msgpack = str(tmp_path / "net_g.msgpack")
    save_pytree(msgpack, {"params": {"w": np.zeros(2, np.float32)}})
    jax_io = JaxOrbaxIO(str(tmp_path / "orbax"), async_save=False)
    jax_io.save(100, {"iter": np.int32(100), "w": np.zeros(3, np.float32)})
    jax_io.close()
    port_io = OrbaxCheckpointIO(str(tmp_path / "dcp"), async_save=False)
    port_io.save(7, {"iter": 7, "state": {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}})
    port_io.close()
    (tmp_path / "dcp" / "8.orbax-checkpoint-tmp-1").mkdir()
    info = ckpt.inspect(str(tmp_path / "dcp"))
    assert (info["format"], info["status"], info["committed_steps"], info["step"]) == \
        ("dcp-root", "ok", [7], 7)
    assert info["in_flight"] == ["8.orbax-checkpoint-tmp-1"]
    assert info["collections"] == {"state": {"tensors": 1, "params": 6, "bytes": 12}}
    assert ckpt.main([str(tmp_path / "dcp")]) == 0
    for path in (jax_state, msgpack):
        got, want = ckpt.inspect(path), jax_ckpt.inspect(path)
        for key in ("format", "status", "integrity", "size_bytes", "collections", "leaves"):
            assert got[key] == want[key], (path, key)
        assert ckpt.main([path]) == 0
    assert ckpt.inspect(jax_state)["step"] == 3
    blob = bytearray(open(msgpack, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(msgpack, "wb").write(bytes(blob))
    capsys.readouterr()
    for path, item in ((msgpack, "crc mismatch"), (str(tmp_path / "orbax"), ".state"),
                       (str(tmp_path / "none.pth"), "")):
        assert ckpt.main([path]) == 1
        assert item in capsys.readouterr().out


# --------------------------------------------------------------- scan_data


def _bad_tree(root, rng):
    """Four good chips, then one of each kind of bad chip."""
    make_tree(root, rng, chips=4)

    def chip(name, naip=None, s2=None):
        write_png(str(root / "naip" / name / f"{name}.png"),
                  naip if naip is not None else (rng.rand(128, 128, 3) * 254 + 1).astype(np.uint8))
        write_png(str(root / "sentinel2" / name / "tci.png"),
                  s2 if s2 is not None else (rng.rand(4 * 32, 32, 3) * 254 + 1).astype(np.uint8))

    naip = (rng.rand(128, 128, 3) * 254 + 1).astype(np.uint8)
    naip[5, 5] = 0
    chip("900_900", naip=naip)
    chip("901_901", s2=(rng.rand(40, 32, 3) * 254 + 1).astype(np.uint8))
    chip("902_902", s2=(rng.rand(32, 32, 3) * 254 + 1).astype(np.uint8))
    s2 = (rng.rand(4 * 32, 32, 3) * 254 + 1).astype(np.uint8)
    s2[::32, 0] = 0
    chip("903_903", s2=s2)
    chip("904_904")
    p = root / "sentinel2" / "904_904" / "tci.png"
    p.write_bytes(p.read_bytes()[:60])
    chip("905_905")
    (root / "naip" / "905_905" / "905_905.png").write_bytes(b"not a png")
    return root


def test_scan_data_report_equals_jax(tmp_path, rng, capsys):
    root = _bad_tree(tmp_path / "tree", rng)
    ds_opt = {"type": "S2NAIPDataset", "phase": "train", "scale": 4,
              "sentinel2_path": str(root / "sentinel2"), "naip_path": str(root / "naip"),
              "n_s2_images": 2}
    got = scan_data.scan_dataset(build_dataset(ds_opt))
    assert got == jax_scan.scan_dataset(jax_build_dataset(ds_opt))
    assert got["chips_unusable"] == 5 and got["issues"]["all_frames_black"]["count"] == 1
    opt = {"datasets": {"train": {k: v for k, v in ds_opt.items() if k != "phase"}}}
    yml = write(opt, tmp_path / "scan.yml")
    out = tmp_path / "r.json"
    assert scan_data.main(["-opt", yml, "--json", str(out)]) == 0
    assert json.loads(out.read_text()) == got
    assert scan_data.main(["-opt", yml, "--strict"]) == 1
    assert scan_data.main(["-opt", yml, "--dataset", "nope"]) == 2


# ------------------------------------------------------------------ doctor


@pytest.mark.parametrize("yml", YMLS)
def test_doctor_rows_equal_jax(yml, monkeypatch):
    for var in ("SSR_TPU_VGG19_WEIGHTS", "SSR_TPU_CLIP_WEIGHTS", "SSR_TPU_LPIPS_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    opt = yaml_load(os.path.join(ROOT, yml))
    kind = "infer" if "data_dir" in opt else "train"
    want = jax_doctor.Report()
    want.add(jax_doctor.OK, "schema", f"linting as a {kind} config")
    jax_doctor._check_config(want, opt, kind)
    jax_doctor._check_towers(want, opt)
    got = doctor.diagnose(opt, check_runtime=False)
    assert [r for r in got.rows if r[1] != "perf"] == [r for r in want.rows if r[1] != "perf"]
    assert got.fetchable == want.fetchable
    assert [r[1] for r in got.rows].count("perf") == [r[1] for r in want.rows].count("perf")


def test_doctor_runtime_on_the_cpu_and_without_a_card(tmp_path, capsys):
    opt = yaml_load(os.path.join(ROOT, "options", "infer_example.yml"))
    opt.update(data_dir=str(tmp_path), path={})
    rows = doctor.diagnose(opt, device="cpu").rows
    assert ("ok", "devices", "cpu (as asked: CUDA not checked)") in rows
    assert not any(r[0] == "ERROR" for r in rows)
    assert doctor.run_doctor(opt, device="cpu") == 0
    if not torch.cuda.is_available():  # the card is asked for and absent: an ERROR, exit 1
        rows = doctor.diagnose(opt).rows
        assert any(r[:2] == ("ERROR", "devices") for r in rows)
        assert doctor.run_doctor(opt) == 1
    opt["spatial_shards"] = 2  # one process: no space group of 2 ranks on this host
    assert any(r[:2] == ("ERROR", "devices") and "does not divide the 1 rank(s)" in r[2]
               for r in doctor.diagnose(opt, device="cpu").rows)


def test_doctor_loads_a_present_tower_file(tmp_path):
    bad = tmp_path / "lpips.pth"
    torch.save({"nothing": torch.zeros(1)}, str(bad))
    opt = {"data_dir": str(tmp_path), "network_g": {}, "test": {"metrics": {
        "lpips": {"type": "calculate_lpips", "lpips_model": "vgg",
                  "lpips_weights_path": str(bad)}}}}
    rows = doctor.diagnose(opt, check_runtime=False).rows
    assert any(r[0] == "ERROR" and r[1] == "towers" and "not loadable" in r[2] for r in rows)


# ------------------------------------------------------------------ warmup


@pytest.mark.parametrize("yml", TRAIN_YMLS)
def test_warmup_synth_batch_equals_jax(yml):
    opt = yaml_load(os.path.join(ROOT, yml))
    for phase, ds in opt["datasets"].items():
        rows = int(ds.get("batch_size_per_gpu", ds.get("batch_size", 1)))
        args = (ds, int(opt.get("scale", 4)), rows, bool(ds.get("old_naip_path")))
        got, want = warmup._synth_batch(*args), jax_warmup._synth_batch(*args)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _infer_yml(tmp_path, batch_size=2, **extra):
    wpath = str(tmp_path / "w.pth")
    save_torch_state_dict(wpath, RRDBNet(num_in_ch=6, num_out_ch=3, num_feat=8, num_block=1,
                                         num_grow_ch=4, device="cpu").state_dict(), "params_ema")
    cfg = {"data_dir": str(tmp_path), "save_path": str(tmp_path / "o"), "n_lr_images": 2,
           "scale": 4, "network_g": {"type": "SSR_RRDBNet", "num_in_ch": 6, "num_out_ch": 3,
                                     "num_feat": 8, "num_block": 1, "num_grow_ch": 4},
           "path": {"pretrain_network_g": wpath, "param_key_g": "params_ema"}, **extra}
    if batch_size:
        cfg["batch_size"] = batch_size
    return write(cfg, tmp_path / "infer.yml")


def test_warmup_train_and_infer_on_the_cpu(tmp_path, rng, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    opt = shipped("esrgan_s2naip_urban.yml", tmp_path, make_tree(tmp_path / "data", rng, chips=2))
    warmup.main(["-opt", write(opt, tmp_path / "t.yml"), "--device", "cpu", "--force_yml",
                 "datasets:train:batch_size_per_gpu=3"])
    out = capsys.readouterr().out
    assert "train step (3 rows)" in out and "eval step 'val'" in out
    assert not (tmp_path / "experiments").exists()  # warmup creates no experiment dirs
    # the halo batch is min(256, windows a tile): halo 6, 6 x 6 windows on a 128-pixel tile
    for kw, want in (({}, "chunked inference (batch 2, 32x32)"),
                     ({"halo": True, "grid_size": 4, "batch_size": None},
                      "halo inference (batch 36, 32x32)"),
                     ({"whole_tile": True, "grid_size": 2, "batch_size": 1},
                      "whole-tile inference (batch 1, 64x64)")):
        warmup.main(["-opt", _infer_yml(tmp_path, **kw), "--device", "cpu"])
        assert want in capsys.readouterr().out


# ----------------------------------------------------------------- profile


def test_profile_infer_and_train_on_the_cpu(tmp_path, rng, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "trace")
    assert profile.main(["-opt", _infer_yml(tmp_path), "--steps", "2", "--out", out,
                         "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "built and ran the infer program (batch 2)" in text and "cpu run: CPU ops" in text
    assert json.load(open(os.path.join(out, "infer_trace.json")))["traceEvents"]
    opt = shipped("srcnn_s2naip_urban.yml", tmp_path, make_tree(tmp_path / "data", rng, chips=2))
    summary = profile.run_profile(write(opt, tmp_path / "l2.yml"), steps=2, out=out,
                                  device="cpu")
    assert summary["device"] == "cpu" and any("conv" in k for k in summary["ops"])
    assert os.path.exists(os.path.join(out, "train_trace.json"))
    assert "built and ran the train step (2 rows)" in capsys.readouterr().out


def test_device_busy_reads_the_raw_trace():
    """device_busy reads the profiler's raw kineto events: a CPU-only trace
    holds no device time (None), and its events carry the names, device
    types and ns times the card's path sums."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).relu()
    assert profile.device_busy(prof) is None
    raw = prof.profiler.kineto_results.events()
    assert any(e.name() == "aten::relu" for e in raw)
    assert all(e.end_ns() >= e.start_ns() for e in raw)

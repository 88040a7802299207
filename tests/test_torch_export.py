"""The port's export (satlas_sr_tpu_torch/export.py) on the CPU.

A `.ssrx` of torch.export programs reproduces the live InferenceEngine bit
for bit (np.array_equal) at the full batch, at a partial batch, at each
bucket program and for a symbolic batch; its graph keeps the
`satlas_sr_torch::rdb` op whole (the kernel on the card); a failed --check
leaves no file; it refuses a pinned-batch mismatch, a device its platforms
do not list and a JAX artifact, and the JAX reader refuses it; an
artifact-backed server answers bit for bit what its engine computes, and
/admin/reload swaps weights under traffic without dropping a request. Tiny
model (nf 8, one block, g 4, 2 frames): four traces shared by the module,
and one of an SRCNN (5-D input, no RDB).
"""

import contextlib
import io
import json
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch
import yaml

from satlas_sr_tpu import export as jax_export
from satlas_sr_tpu_torch import export as export_mod
from satlas_sr_tpu_torch.archs import RRDBNet
from satlas_sr_tpu_torch.export import (ARTIFACT_FORMAT, ExportedEngine, export_artifact,
                                        main as export_main, read_artifact_meta)
from satlas_sr_tpu_torch.infer import load_infer_variables
from satlas_sr_tpu_torch.inference import InferenceEngine
from satlas_sr_tpu_torch.serve import build_server, resolve_buckets
from satlas_sr_tpu_torch.utils.imgio import encode_png_bytes, read_png_bytes
from satlas_sr_tpu_torch.utils.infer_utils import format_s2naip_data
from satlas_sr_tpu_torch.utils.model_utils import build_network
from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict
from torch_threads import two_torch_threads  # noqa: F401

N_FRAMES = 2
NET = dict(num_in_ch=N_FRAMES * 3, num_out_ch=3, num_feat=8, num_block=1, num_grow_ch=4)


def _opt(weights, batch_size=8):
    return {"n_lr_images": N_FRAMES, "scale": 4, "batch_size": batch_size, "manual_seed": 7,
            "compute_dtype": "float32",
            "network_g": {"type": "SSR_RRDBNet", **NET},
            "path": {"pretrain_network_g": weights, "param_key_g": "params_ema"}}


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """Artifacts: A through the CLI (batch 8, bucket 2, --check), A with a
    symbolic batch, B of other weights (batch 8, one program)."""
    root = tmp_path_factory.mktemp("export")
    opts = {}
    for name, seed in (("a", 0), ("b", 1)):
        weights = str(root / f"net_g_{name}.pth")
        save_torch_state_dict(weights, RRDBNet(seed=seed, device="cpu", **NET).state_dict(),
                              param_key="params_ema")
        opts[name] = _opt(weights)
    cfg = root / "infer.yml"
    cfg.write_text(yaml.safe_dump(opts["a"]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        export_main(["-opt", str(cfg), "-o", str(root / "a.ssrx"), "--batch", "8",
                     "--platforms", "cpu", "--check", "--buckets", "2", "--device", "cpu"])
    export_artifact(opts["a"], str(root / "a_sym.ssrx"), symbolic_batch=True,
                    platforms=("cpu",), device="cpu")
    export_artifact(opts["b"], str(root / "b.ssrx"), platforms=("cpu",), device="cpu")
    return {"root": root, "opts": opts, "cli": out.getvalue(), "a": str(root / "a.ssrx"),
            "sym": str(root / "a_sym.ssrx"), "b": str(root / "b.ssrx")}


def _live(opt, batch_size=8):
    model = build_network(opt, device="cpu")
    return InferenceEngine(model, load_infer_variables(opt, model), batch_size=batch_size,
                           n_frames=N_FRAMES, device="cpu")


def _batch(rng, n):
    return (rng.rand(n, 32, 32, N_FRAMES * 3) * 255).astype(np.uint8)


def test_export_cli_roundtrip_bitexact(arts, rng):
    assert "check ok" in arts["cli"] and "exported SSR_RRDBNet" in arts["cli"]
    meta = read_artifact_meta(arts["a"])
    assert meta["format"] == ARTIFACT_FORMAT == "ssrx-torch-v1"
    assert meta["checked"] is True and meta["batch_size"] == 8 and meta["platforms"] == ["cpu"]
    assert meta["bucket_batches"] == [2, 8] and meta["input_dims"] == [32, 32, N_FRAMES * 3]
    assert meta["compute_dtype"] == "float32" and meta["use_3d"] is False
    with zipfile.ZipFile(arts["a"]) as z:
        assert sorted(z.namelist()) == ["cpu/module.pt2", "cpu/module_b2.pt2", "meta.json"]
    engine, loaded = _live(arts["opts"]["a"]), ExportedEngine(arts["a"], device="cpu")
    for n in (8, 3):  # full and partial batch
        x = _batch(rng, n)
        assert np.array_equal(loaded.run(x), engine.run(x))
    assert [loaded.round_bucket(b) for b in (1, 2, 3, 64)] == [2, 2, 8, 8]
    x = _batch(rng, 2)
    got = loaded.fetch(loaded.dispatch(x, bucket=2))
    assert np.array_equal(got, engine.fetch(engine.dispatch(x, bucket=2)))


def test_exported_graph_calls_the_rdb_op(arts):
    """The traced graph keeps the RDB as the op (one per RDB: the card runs
    the kernel), with its weights as the program's buffers."""
    loaded = ExportedEngine(arts["a"], device="cpu")
    assert sorted(loaded._programs) == [2, 8]
    for program in loaded._programs.values():
        ops = [n for n in program.graph.nodes if n.target is torch.ops.satlas_sr_torch.rdb.default]
        assert len(ops) == 3  # one RRDB: three RDBs


def test_export_symbolic_batch_and_batch_precedence(arts, rng):
    meta = read_artifact_meta(arts["sym"])
    assert meta["batch_size"] is None and "bucket_batches" not in meta
    engine = _live(arts["opts"]["a"])
    loaded = ExportedEngine(arts["sym"], batch_size=5, device="cpu")
    assert loaded.batch_size == 5 and loaded.round_bucket(3) == 3
    for n in (5, 2, 9):
        x = _batch(rng, n)
        assert np.array_equal(loaded.run(x), engine.run(x))
    # explicit > caller default (serve passes the config's) > 64; a pin wins
    assert ExportedEngine(arts["sym"], device="cpu").batch_size == 64
    assert ExportedEngine(arts["sym"], default_batch_size=8, device="cpu").batch_size == 8
    assert ExportedEngine(arts["sym"], batch_size=5, default_batch_size=8,
                          device="cpu").batch_size == 5
    assert ExportedEngine(arts["a"], default_batch_size=16, device="cpu").batch_size == 8


def test_export_buckets_resolve_in_serve(arts):
    assert resolve_buckets(ExportedEngine(arts["a"], device="cpu"), "auto") == [2, 8]
    assert resolve_buckets(ExportedEngine(arts["b"], device="cpu"), "auto") == [8]
    with pytest.raises(ValueError, match="symbolic"):
        export_artifact(arts["opts"]["a"], str(arts["root"] / "x.ssrx"), symbolic_batch=True,
                        platforms=("cpu",), buckets=[2], device="cpu")


def test_export_failed_check_leaves_no_artifact(arts, monkeypatch):
    """A program that does not compute the live engine's function (here A's,
    shipped under B's config) fails --check, and nothing is left at the
    path or at its .tmp."""
    with zipfile.ZipFile(arts["a"]) as z:
        wrong = z.read("cpu/module.pt2")
    monkeypatch.setattr(export_mod, "_export_program", lambda *a, **k: wrong)
    path = arts["root"] / "bad.ssrx"
    with pytest.raises(AssertionError, match="differs from the live engine"):
        export_artifact(arts["opts"]["b"], str(path), platforms=("cpu",), check=True,
                        device="cpu")
    assert not path.exists() and not (arts["root"] / "bad.ssrx.tmp").exists()


def _with_meta(src, dst, **changes):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename == "meta.json":
                data = json.dumps({**json.loads(data), **changes}).encode()
            zout.writestr(item, data)
    return str(dst)


def test_export_refusals(arts):
    with pytest.raises(ValueError, match="fixed batch of 8"):
        ExportedEngine(arts["a"], batch_size=4, device="cpu")
    cuda_only = _with_meta(arts["a"], arts["root"] / "cuda_only.ssrx", platforms=["cuda"])
    with pytest.raises(RuntimeError, match=r"exported for \['cuda'\].*'cpu'"):
        ExportedEngine(cuda_only, device="cpu")
    other = _with_meta(arts["a"], arts["root"] / "other.ssrx", format="other")
    with pytest.raises(ValueError, match="unsupported artifact format"):
        read_artifact_meta(other)
    # the JAX reader refuses the port's artifact
    with pytest.raises(ValueError, match="unsupported artifact format 'ssrx-torch-v1'"):
        jax_export.read_artifact_meta(arts["a"])
    if not torch.cuda.is_available():  # no quiet move to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExportedEngine(arts["a"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export_artifact(arts["opts"]["a"], str(arts["root"] / "c.ssrx"),
                            platforms=("cuda", "cpu"), device="cpu")


def test_export_refuses_a_jax_artifact(arts):
    """A real JAX .ssrx: refused by name, naming both formats."""
    path = str(arts["root"] / "jax.ssrx")
    jax_export.export_artifact(arts["opts"]["a"], path, platforms=("cpu",))
    for load in (read_artifact_meta, lambda p: ExportedEngine(p, device="cpu")):
        with pytest.raises(ValueError, match="ssrx-v1.*ssrx-torch-v1"):
            load(path)


def _post(url, body, token=None):
    req = urllib.request.Request(url, data=body, method="POST")
    if token:
        req.add_header("X-Admin-Token", token)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serve_artifact_and_reload_under_traffic(arts, rng):
    """The artifact server answers what ExportedEngine computes; reload:
    403 on a wrong token, 409 (old engine still serving) on a bad path,
    then a swap to B under a client's traffic with every request answered;
    later answers are B's."""
    opt = arts["opts"]["a"]
    server, batcher = build_server(opt, port=0, max_wait_ms=5.0, timeout_s=120.0,
                                   artifact=arts["a"], admin_token="sekrit", device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        series = (rng.rand(N_FRAMES * 32, 32, 3) * 254 + 1).astype(np.uint8)
        body = encode_png_bytes(series)
        stacked = format_s2naip_data(series, N_FRAMES, rng=np.random.RandomState(7))[0][None]
        want = {k: ExportedEngine(arts[k], device="cpu").run(stacked)[0] for k in ("a", "b")}
        code, out_a = _post(base + "/v1/sr", body)
        assert code == 200 and np.array_equal(read_png_bytes(out_a), want["a"])
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["platform"] == "cpu" and health["artifact"] == arts["a"]

        reload = lambda art, token="sekrit": _post(
            base + "/admin/reload", json.dumps({"artifact": art}).encode(), token)
        assert reload(arts["b"], token="wrong")[0] == 403
        code, msg = reload(str(arts["root"] / "nope.ssrx"))
        assert code == 409 and b"still serving" in msg
        assert _post(base + "/v1/sr", body) == (200, out_a)

        stop, answers = threading.Event(), []

        def client():
            while not stop.is_set():
                answers.append(_post(base + "/v1/sr", body))

        traffic = threading.Thread(target=client)
        traffic.start()
        code, info = reload(arts["b"])
        answers_at_swap = len(answers)
        while len(answers) < answers_at_swap + 3:
            threading.Event().wait(0.01)
        stop.set()
        traffic.join()
        assert code == 200 and json.loads(info)["generation"] == 1
        assert all(c == 200 for c, _ in answers)
        got = [read_png_bytes(b) for _, b in answers]
        assert all(np.array_equal(g, want["a"]) or np.array_equal(g, want["b"]) for g in got)
        assert all(np.array_equal(g, want["b"]) for g in got[answers_at_swap + 1:])
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["reload_generation"] == 1 and health["artifact"] == arts["b"]
    finally:
        server.shutdown()
        server.server_close()
        server.ctx["batcher"].close()
        thread.join(timeout=10)


def test_serve_artifact_frame_mismatch_refused(arts):
    bad = dict(arts["opts"]["a"], n_lr_images=N_FRAMES + 1)
    bad["network_g"] = dict(bad["network_g"], num_in_ch=(N_FRAMES + 1) * 3)
    with pytest.raises(ValueError, match="n_lr_images"):
        build_server(bad, port=0, artifact=arts["a"], device="cpu")


def test_export_use_3d_srcnn(tmp_path, rng):
    """A model without RDBs and with 5-D revisit input: the stacked 4-D
    batch the CLIs give preps the same on both sides."""
    opt = {"n_lr_images": N_FRAMES, "scale": 4, "batch_size": 2,
           "network_g": {"type": "SRCNN", "in_channels": 3, "mask_channels": 0,
                         "revisits": N_FRAMES, "hidden_channels": 16, "out_channels": 3,
                         "kernel_size": 3, "residual_layers": 1, "output_size": 128,
                         "zoom_factor": 4, "sr_kernel_size": 1},
           "path": {}}
    path = str(tmp_path / "srcnn.ssrx")
    meta = export_artifact(opt, path, platforms=("cpu",), check=True, device="cpu")
    assert meta["use_3d"] is True and meta["input_dims"] == [N_FRAMES, 32, 32, 3]
    model = build_network(opt, device="cpu")
    engine = InferenceEngine(model, batch_size=2, use_3d=True, n_frames=N_FRAMES, device="cpu")
    x = _batch(rng, 2)
    assert np.array_equal(ExportedEngine(path, device="cpu").run(x), engine.run(x))


def test_rdb_op_passes_opcheck(rng):
    """The op's schema, fake and registration hold up under torch.library's
    own checks (what torch.export relies on), and on the CPU it is the plain
    version."""
    from satlas_sr_tpu_torch.ops.cuda.rdb import rdb_op, rdb_reference

    x = torch.from_numpy(rng.randn(2, 8, 8, 8).astype(np.float32))
    kernels = [torch.from_numpy(rng.randn(4 if k < 4 else 8, 8 + 4 * k, 3, 3).astype(np.float32))
               for k in range(5)]
    biases = [torch.from_numpy(rng.randn(4 if k < 4 else 8).astype(np.float32)) for k in range(5)]
    torch.library.opcheck(rdb_op, (x, kernels, torch.cat(biases), 8, 4))
    assert torch.equal(rdb_op(x, kernels, torch.cat(biases), 8, 4),
                       rdb_reference(x, kernels, biases, 8, 4))

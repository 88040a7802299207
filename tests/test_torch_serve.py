"""The port's serving daemon (satlas_sr_tpu_torch/serve.py) on the CPU.

One seeded RRDBNet (nf 8, one block, g 4, 2 frames) saved as a reference
.pth drives both packages: the port's server answers over HTTP
bit for bit what its engine computes for the formatted input, and that
engine is within 1 level on <= 0.1% of values of the JAX InferenceEngine on
the same .pth (float rounding at a truncation boundary moves one level).
The micro-batcher's tests run on both packages' MicroBatcher over one
FakeEngine, and the bucket choice is held equal between them on one
sequence of gathers. The error paths follow tests/test_serve.py.
"""

import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from satlas_sr_tpu import serve as jax_serve
from satlas_sr_tpu.infer import load_infer_variables as jax_load_infer_variables
from satlas_sr_tpu.inference import InferenceEngine as JaxEngine
from satlas_sr_tpu.utils.model_utils import build_network as jax_build_network
from satlas_sr_tpu_torch import serve as port_serve
from satlas_sr_tpu_torch.archs import RRDBNet
from satlas_sr_tpu_torch.inference import InferenceEngine
from satlas_sr_tpu_torch.serve import MAX_IMAGE_PIXELS, build_server
from satlas_sr_tpu_torch.utils import imgio, native_png
from satlas_sr_tpu_torch.utils.imgio import encode_png_bytes, read_png_bytes
from satlas_sr_tpu_torch.utils.infer_utils import format_s2naip_data
from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict
from torch_threads import two_torch_threads  # noqa: F401

N_FRAMES = 2
NET = dict(num_in_ch=N_FRAMES * 3, num_out_ch=3, num_feat=8, num_block=1, num_grow_ch=4)
PACKAGES = {"port": port_serve, "jax": jax_serve}


def _opt(weights, batch_size=8):
    return {"n_lr_images": N_FRAMES, "scale": 4, "batch_size": batch_size, "manual_seed": 7,
            "network_g": {"type": "SSR_RRDBNet", **NET},
            "path": {"pretrain_network_g": weights, "param_key_g": "params_ema",
                     "strict_load_g": True}}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A seeded reference-format .pth, read by both packages' importers."""
    path = str(tmp_path_factory.mktemp("serve") / "net_g.pth")
    save_torch_state_dict(path, RRDBNet(seed=3, device="cpu", **NET).state_dict(),
                          param_key="params_ema")
    return path


@pytest.fixture(scope="module")
def server(weights):
    """The port's server on the CPU: batch 8 with a bucket of 2."""
    opt = _opt(weights)
    srv, batcher = build_server(opt, port=0, max_wait_ms=20.0, timeout_s=120.0, buckets=[2],
                                device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", srv, batcher, opt
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
        thread.join(timeout=10)


def _post(url, body, accept=None, method="POST"):
    req = urllib.request.Request(url, data=body, method=method)
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _series(rng, n_frames=4):
    return (rng.rand(n_frames * 32, 32, 3) * 254 + 1).astype(np.uint8)


def _formatted(series, seed=7):
    return np.stack([format_s2naip_data(s, N_FRAMES, rng=np.random.RandomState(seed))[0]
                     for s in series])


def test_serve_png_matches_engine_and_jax(server, rng):
    """Six concurrent PNG requests equal the port engine's output bit for
    bit; the port engine is within 1 level on <= 0.1% of values of the JAX
    engine on the same .pth."""
    base, _, batcher, opt = server
    series = [_series(rng) for _ in range(6)]
    formatted = _formatted(series)
    expected = batcher.engine.run(formatted)
    with ThreadPoolExecutor(max_workers=6) as pool:
        results = list(pool.map(lambda s: _post(base + "/v1/sr", encode_png_bytes(s)), series))
    for i, (status, body, headers) in enumerate(results):
        assert status == 200, body
        assert headers["Content-Type"] == "image/png"
        np.testing.assert_array_equal(read_png_bytes(body), expected[i])

    model = jax_build_network(opt)
    variables = jax_load_infer_variables(opt, model, N_FRAMES, False)
    want = JaxEngine(model, variables, batch_size=8, n_frames=N_FRAMES,
                     use_mesh=False).run(formatted)
    assert want.shape == expected.shape == (6, 128, 128, 3)
    diff = np.abs(expected.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_serve_raw_output_and_observability(server, rng):
    """Raw answers; four serial requests decay the fill EWMA of earlier
    traffic, so the later ones run on bucket 2 (counted in /stats)."""
    base, _, batcher, opt = server
    for _ in range(4):
        s = _series(rng)
        status, body, headers = _post(base + "/v1/sr", encode_png_bytes(s),
                                      accept="application/octet-stream")
        assert status == 200 and headers["X-Shape"] == "128,128,3"
        assert headers["X-Dtype"] == "uint8"
        raw = np.frombuffer(body, np.uint8).reshape(128, 128, 3)
        np.testing.assert_array_equal(raw, batcher.engine.run(_formatted([s]))[0])

    status, body, _ = _post(base + "/healthz", None, method="GET")
    health = json.loads(body)
    assert status == 200 and health["status"] == "ok" and health["platform"] == "cpu"
    assert health["model"] == "SSR_RRDBNet" and health["n_lr_images"] == N_FRAMES
    assert health["buckets"] == [2, 8] and health["reload_generation"] == 0

    status, body, _ = _post(base + "/stats", None, method="GET")
    stats = json.loads(body)
    assert status == 200 and stats["requests_total"] >= 1 and stats["batches_total"] >= 1
    assert stats["latency_ms"]["count"] >= 1 and stats["batches_by_bucket"]["2"] >= 1

    status, body, headers = _post(base + "/metrics", None, method="GET")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    text = body.decode()
    metrics = {l.split()[0]: float(l.split()[1])
               for l in text.splitlines() if l and not l.startswith("#")}
    assert metrics["sr_requests_total"] >= stats["requests_total"]
    assert metrics["sr_batches_total"] >= 1 and "sr_latency_ms_p50" in metrics
    assert 'sr_bucket_batches_total{bucket="2"}' in text


def test_serve_rejects_bad_requests(server, rng):
    base = server[0]
    status, body, _ = _post(base + "/v1/sr", b"this is not a png")
    assert status == 400 and b"PNG" in body
    status, body, _ = _post(base + "/v1/sr", encode_png_bytes((rng.rand(64, 30, 3) * 255)
                                                              .astype(np.uint8)))
    assert status == 400 and b"[T*32, 32, 3]" in body
    status, body, _ = _post(base + "/v1/sr", encode_png_bytes(_series(rng, n_frames=1)))
    assert status == 400 and b"frames" in body
    assert _post(base + "/nope", b"x")[0] == 404
    assert _post(base + "/nope", None, method="GET")[0] == 404


def _raw_http(base, head: bytes) -> bytes:
    host, port = base.removeprefix("http://").split(":")
    with socket.create_connection((host, int(port)), timeout=30) as sock:
        sock.sendall(head)
        chunks = []
        while True:
            data = sock.recv(65536)
            if not data:
                return b"".join(chunks)
            chunks.append(data)


def test_serve_length_errors_close_the_connection(server):
    """411 without a body length and 413 above MAX_BODY_BYTES answer before
    the body is read, and close the connection (the socket reaches EOF)."""
    base = server[0]
    got = _raw_http(base, b"POST /v1/sr HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n")
    assert got.startswith(b"HTTP/1.1 411")
    got = _raw_http(base, b"POST /v1/sr HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
                    % (port_serve.MAX_BODY_BYTES + 1))
    assert got.startswith(b"HTTP/1.1 413")


def test_serve_decode_bomb_rejected(server):
    """A small body whose decoded size exceeds the pixel cap is refused from
    the PNG header."""
    bomb = encode_png_bytes(np.zeros((513 * 32, 32, 3), np.uint8))
    assert len(bomb) < 1 << 20
    status, body, _ = _post(server[0] + "/v1/sr", bomb)
    assert status == 400 and b"pixels" in body


def test_serve_error_paths_close_keepalive_connection(server):
    host, port = server[0].removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/nope", body=b"x" * 4096)
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        try:
            conn.request("GET", "/healthz")
            resp2 = conn.getresponse()
            assert resp2.will_close or resp2.status == 200
        except (http.client.HTTPException, ConnectionError, BrokenPipeError, TimeoutError):
            pass
    finally:
        conn.close()


def test_admin_reload_404_without_token(server):
    assert _post(server[0] + "/admin/reload", json.dumps({"artifact": "x"}).encode())[0] == 404


def test_server_needs_the_card_unless_asked_for_the_cpu(weights):
    """No quiet move to the CPU: the default device is cuda."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_server(_opt(weights), port=0)


# ------------------------------------------------------------ image bytes


def test_png_bytes_roundtrip_and_header_cap(rng):
    img = (rng.rand(64, 32, 3) * 255).astype(np.uint8)
    data = encode_png_bytes(img)
    np.testing.assert_array_equal(read_png_bytes(data), img)
    gray = (rng.rand(8, 8, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png_bytes(encode_png_bytes(gray)), gray)
    with pytest.raises(ValueError, match="pixel limit"):
        read_png_bytes(data, max_pixels=64 * 32 - 1)
    assert read_png_bytes(data, max_pixels=64 * 32).shape == (64, 32, 3)


def test_png_bytes_pil_path_follows_the_native_rules(rng, monkeypatch):
    """Where the codec is absent, PIL decodes with the same channel rules
    (gray -> HW1, alpha dropped) and checks the cap from the header."""
    import io

    from PIL import Image

    rgba = (rng.rand(16, 8, 4) * 255).astype(np.uint8)
    gray = (rng.rand(16, 8) * 255).astype(np.uint8)
    bodies = {}
    for name, arr in (("rgba", rgba), ("gray", gray)):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        bodies[name] = buf.getvalue()
    native = {k: read_png_bytes(v) for k, v in bodies.items()}
    monkeypatch.setattr(native_png, "decode_png_bytes", lambda *a, **k: None)
    monkeypatch.setattr(native_png, "encode_png_bytes", lambda *a, **k: None)
    for k, v in bodies.items():
        np.testing.assert_array_equal(read_png_bytes(v), native[k])
    assert native["rgba"].shape == (16, 8, 3) and native["gray"].shape == (16, 8, 1)
    with pytest.raises(native_png.ImageTooLarge):
        read_png_bytes(bodies["rgba"], max_pixels=127)
    np.testing.assert_array_equal(read_png_bytes(imgio.encode_png_bytes(rgba[..., :3])),
                                  rgba[..., :3])


def test_max_image_pixels_matches_jax():
    assert MAX_IMAGE_PIXELS == jax_serve.MAX_IMAGE_PIXELS
    assert port_serve.MAX_BODY_BYTES == jax_serve.MAX_BODY_BYTES


# ------------------------------------------------- engine: buckets, threads


def test_engine_buckets_pad_to_the_bucket(rng):
    engine = InferenceEngine(RRDBNet(device="cpu", **NET), batch_size=8, n_frames=N_FRAMES,
                             device="cpu")
    assert [engine.round_bucket(b) for b in (0, 1, 3, 8, 100)] == [1, 1, 3, 8, 8]
    x = (rng.rand(3, 32, 32, N_FRAMES * 3) * 255).astype(np.uint8)
    handle = engine.dispatch(x, bucket=4)
    assert handle[0] == 3 and handle[1].shape == (4, 128, 128, 3)
    got = engine.fetch(handle)
    np.testing.assert_array_equal(got, engine.run(x))  # per-image convs: no cross-talk
    # dispatch on one thread, fetch on another (the micro-batcher's split)
    with ThreadPoolExecutor(max_workers=1) as pool:
        handles = [engine.dispatch(x[:k], bucket=4) for k in (1, 2, 3)]
        outs = list(pool.map(engine.fetch, handles))
    for k, y in zip((1, 2, 3), outs):
        np.testing.assert_array_equal(y, got[:k])


def test_precision_holds_under_concurrent_engines():
    """Two engines on two threads (a hot reload warms one while the other
    serves) each see their own TF32 setting for the whole of a call, and
    the process's flags come back as they were: more threads than cores, a
    short switch interval."""
    import sys

    from satlas_sr_tpu_torch.inference import _precision

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    before, bad = flags(), []

    def worker(mode):
        want = (mode != "highest",) * 2
        for _ in range(200):
            with _precision(mode):
                for _ in range(3):
                    if flags() != want:
                        bad.append(mode)
                    time.sleep(0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(m,))
                   for m in ("highest", "default") * 8]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not bad and flags() == before


# ---------------------------------------------- micro-batcher, both packages


class FakeEngine:
    """Engine stand-in recording batch compositions; y = x + 1."""

    def __init__(self, batch_size=8):
        self.batch_size = batch_size
        self.batches = []
        self.buckets_seen = []
        self.gate = threading.Event()
        self.gate.set()
        self.fail_next = False

    def round_bucket(self, b):
        return min(self.batch_size, max(1, int(b)))

    def dispatch(self, batch, bucket=None):
        self.gate.wait(timeout=30)
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("injected dispatch failure")
        self.buckets_seen.append(bucket)
        self.batches.append(batch.shape[0])
        return batch

    def fetch(self, handle):
        return handle + 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_microbatcher_coalesces_while_device_busy(pkg):
    eng = FakeEngine(batch_size=8)
    mb = PACKAGES[pkg].MicroBatcher(eng, (32, 32, 6), max_wait_ms=5.0, depth=1)
    try:
        x = np.zeros((32, 32, 6), np.uint8)
        eng.gate.clear()
        first = mb.submit(x)
        time.sleep(0.1)
        later = [mb.submit(x) for _ in range(4)]
        eng.gate.set()
        assert first.result(timeout=30).shape == (32, 32, 6)
        for f in later:
            np.testing.assert_array_equal(f.result(timeout=30), np.ones((32, 32, 6), np.uint8))
        assert sum(eng.batches) == 5
        assert len(eng.batches) <= 2 and max(eng.batches) >= 4
    finally:
        mb.close()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_microbatcher_backpressure_and_errors(pkg):
    serve = PACKAGES[pkg]
    eng = FakeEngine(batch_size=4)
    mb = serve.MicroBatcher(eng, (2, 2, 3), max_wait_ms=1.0, max_queue=2, depth=1)
    x = np.zeros((2, 2, 3), np.uint8)
    try:
        with pytest.raises(ValueError):
            mb.submit(np.zeros((3, 3, 3), np.uint8))
        with pytest.raises(ValueError):
            mb.submit(x.astype(np.float32))
        eng.gate.clear()
        inflight = mb.submit(x)
        time.sleep(0.05)
        queued = [mb.submit(x), mb.submit(x)]
        with pytest.raises(serve.QueueFullError):
            mb.submit(x)
        eng.fail_next = True
        eng.gate.set()
        with pytest.raises(RuntimeError, match="injected"):
            inflight.result(timeout=30)
        for f in queued:
            f.result(timeout=30)
    finally:
        mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(x)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_microbatcher_close_drains_pending(pkg):
    eng = FakeEngine(batch_size=4)
    mb = PACKAGES[pkg].MicroBatcher(eng, (2, 2, 3), max_wait_ms=1000.0, depth=1)
    x = np.zeros((2, 2, 3), np.uint8)
    eng.gate.clear()
    futs = [mb.submit(x) for _ in range(3)]
    threading.Timer(0.1, eng.gate.set).start()
    mb.close()
    assert all(f.done() for f in futs) and sum(eng.batches) == 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_microbatcher_bucket_selection(pkg):
    eng = FakeEngine(batch_size=8)
    mb = PACKAGES[pkg].MicroBatcher(eng, (2, 2, 3), max_wait_ms=5.0, depth=1, buckets=[2])
    x = np.zeros((2, 2, 3), np.uint8)
    try:
        assert mb.buckets == [2, 8]
        mb.submit(x).result(timeout=30)
        eng.gate.clear()
        first = mb.submit(x)
        time.sleep(0.1)
        later = [mb.submit(x) for _ in range(5)]
        eng.gate.set()
        for f in [first] + later:
            f.result(timeout=30)
        assert eng.buckets_seen[0] == 2 and 8 in eng.buckets_seen
        assert mb.bucket_batches[2] >= 1 and mb.bucket_batches[8] >= 1
    finally:
        mb.close()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_resolve_buckets(pkg):
    resolve = PACKAGES[pkg].resolve_buckets
    eng = FakeEngine(batch_size=64)
    assert resolve(eng, None) == [64]
    assert resolve(eng, "auto") == [8, 64]
    assert resolve(eng, [4, 100, 4]) == [4, 64]
    assert PACKAGES[pkg].parse_buckets_arg("auto") == "auto"
    assert PACKAGES[pkg].parse_buckets_arg("none") is None
    assert PACKAGES[pkg].parse_buckets_arg("2, 8,") == [2, 8]


def test_pick_bucket_same_in_both_packages(rng):
    """One sequence of gathers through both packages' _pick_bucket: the same
    buckets and the same fill EWMA after every gather."""
    gathers = [1] + [64] * 10 + [5, 64] + [1] * 21 + [33] + list(rng.randint(1, 65, 200))
    eng = FakeEngine(batch_size=64)
    mbs = [PACKAGES[p].MicroBatcher(eng, (2, 2, 3), depth=1, buckets=[8]) for p in PACKAGES]
    try:
        picks = [[], []]
        for n in gathers:
            for k, mb in enumerate(mbs):
                picks[k].append((mb._pick_bucket(int(n)), mb.fill_ewma))
        assert picks[0] == picks[1]
        # the load-aware policy itself (tests/test_serve.py)
        assert [p for p, _ in picks[0][:13]] == [8] + [64] * 12
        assert picks[0][33][0] == 8 and picks[0][34][0] == 64
    finally:
        for mb in mbs:
            mb.close()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_reload_engine_drains_old_inflight(pkg, monkeypatch):
    """Requests queued on the old engine resolve with its results after the
    swap; later submissions run the new engine."""
    serve = PACKAGES[pkg]
    old_eng = FakeEngine(batch_size=4)

    class Plus2(FakeEngine):
        def fetch(self, handle):
            return handle + 2

    new_eng = Plus2(batch_size=4)
    shape = (32, 32, 6)
    ctx = {"batcher": serve.MicroBatcher(old_eng, shape, max_wait_ms=5.0, depth=1), "opt": {},
           "batch_size": None, "reload_lock": threading.Lock(), "reloads": 0}
    monkeypatch.setattr(serve, "_build_engine",
                        lambda *a, **k: (new_eng, "fake", shape))
    x = np.zeros(shape, np.uint8)
    old_eng.gate.clear()
    pending = [ctx["batcher"].submit(x) for _ in range(3)]
    done, result = threading.Event(), {}

    def _reload():
        result.update(serve.reload_engine(ctx, "new.ssrx"))
        done.set()

    threading.Thread(target=_reload, daemon=True).start()
    time.sleep(0.2)
    old_eng.gate.set()
    assert done.wait(timeout=30)
    for f in pending:
        np.testing.assert_array_equal(f.result(timeout=30), np.ones(shape, np.uint8))
    assert result["generation"] == 1
    np.testing.assert_array_equal(ctx["batcher"].submit(x).result(timeout=30),
                                  2 * np.ones(shape, np.uint8))
    ctx["batcher"].close()


def test_main_lists_the_entry_points(capsys):
    import importlib

    from satlas_sr_tpu_torch.__main__ import CLIS, main

    assert main() == 0
    out = capsys.readouterr().out
    for name, _ in CLIS:
        assert f"satlas_sr_tpu_torch.{name}" in out
        assert hasattr(importlib.import_module(f"satlas_sr_tpu_torch.{name}"), "main")

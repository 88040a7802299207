"""Serving daemon: HTTP super-resolution with micro-batching on the card.

Counterpart of satlas_sr_tpu/serve.py, with the same behaviour: a
long-lived server process holding ONE engine and coalescing concurrent
requests into device batches. The server runs a SMALL SET of batch shapes
[b, 32, 32, T*3] (batch-shape buckets, default [batch/8, batch]): requests
are micro-batched (a dispatcher waits up to `max_wait_ms` to fill a batch),
the smallest bucket covering the gathered requests runs, and trailing slots
are padded, exactly like the infer CLI pads its final batch. A fill-1
request at low traffic then computes 8 slots, not 64. Every batch of an
esrgan config is one RRDBNet forward: 69 launches of the RDB kernel
(ops/cuda/rdb.py) at [bucket, 32, 32, 64]. Dispatch and result-fetch run on
separate threads so host->device transfer, device compute and readback of
consecutive batches overlap (InferenceEngine.dispatch/.fetch: the engine's
own CUDA stream, pinned buffers, one event a batch), with a bounded
in-flight window for backpressure.

Endpoints:
  POST /v1/sr    body: PNG of a [T*32, 32, 3] stacked Sentinel-2 time series
                 (the same file format the infer CLI consumes). Response:
                 image/png of the 4x-SR RGB output; `Accept:
                 application/octet-stream` returns raw uint8 bytes with an
                 `X-Shape` header instead.
  GET  /healthz  liveness + model/config JSON (+ reload generation); its
                 `platform` is the engine's device type (cuda or cpu)
  GET  /stats    request/batch counters, queue depth, latency quantiles
  GET  /metrics  the same as Prometheus text
  POST /admin/reload  zero-downtime weight rollover: body {"artifact":
                 "new.ssrx"} loads + warms the new engine, atomically swaps
                 it under the live traffic, then drains the old batcher:
                 in-flight requests complete on the old weights, every later
                 request runs the new ones. Requires --admin-token (the
                 endpoint is 404 without one). SIGHUP re-loads the current
                 --artifact path in place (rollout = atomically replace the
                 .ssrx file, then `kill -HUP`).

The server runs on --device (default cuda) and raises where it is absent:
it never moves to the CPU by itself.

Run: python -m satlas_sr_tpu_torch.serve -opt options/infer_example.yml --port 8000
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time
from collections import deque
from concurrent import futures
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Queue
from typing import Optional, Tuple

import numpy as np

MAX_BODY_BYTES = 16 << 20
# Largest decoded request image: a [T*32, 32, 3] series up to T=512 frames.
MAX_IMAGE_PIXELS = 512 * 32 * 32


class QueueFullError(RuntimeError):
    """Raised by MicroBatcher.submit when the request queue is at its limit."""


def parse_buckets_arg(spec: str):
    """CLI `--buckets` string -> resolve_buckets input ('none' -> single
    full-batch shape, 'auto' -> one small bucket, else comma ints)."""
    if spec == "none":
        return None
    if spec == "auto":
        return "auto"
    return [int(b) for b in spec.split(",") if b.strip()]


def resolve_buckets(engine, buckets) -> list:
    """Sorted batch shapes for dispatch-time bucket selection.

    `buckets` is None (single full-batch shape), the string 'auto' (one
    small bucket of ~batch_size/8 next to the full batch), or an iterable
    of ints. Entries are rounded to valid engine batches (capped at
    batch_size) and the full batch is always kept so saturation throughput
    is unchanged. Fixed-batch .ssrx artifacts round to the programs they
    ship: single-shape exports collapse to [batch_size]; multi-bucket
    exports (`export --buckets`) keep their small shapes.
    """
    bs = engine.batch_size
    rounder = getattr(engine, "round_bucket", None) \
        or (lambda b: min(bs, max(1, int(b))))
    if buckets is None:
        return [bs]
    if buckets == "auto":
        buckets = [bs // 8] if bs >= 8 else []
    return sorted({rounder(int(b)) for b in buckets} | {bs})


class MicroBatcher:
    """Coalesces single-image requests into fixed-size engine batches.

    A dispatcher thread gathers up to `engine.batch_size` queued inputs,
    waiting at most `max_wait_ms` after the first arrival (latency bound),
    then dispatches asynchronously; a fetcher thread blocks on results and
    resolves the per-request futures. The in-flight window is capped at
    `depth` batches — when the device falls behind, dispatch blocks, the
    queue fills, and submit() starts failing fast with QueueFullError
    (backpressure instead of unbounded memory growth).
    """

    def __init__(self, engine, input_shape: Tuple[int, ...],
                 max_wait_ms: float = 5.0, max_queue: int = 512, depth: int = 2,
                 buckets=None):
        self.engine = engine
        self.input_shape = tuple(input_shape)
        self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        self.max_queue = int(max_queue)
        self._cond = threading.Condition()
        self._items: deque = deque()  # (np input, Future)
        self._closed = False
        self._inflight: Queue = Queue(maxsize=max(1, int(depth)))
        self.batches_total = 0
        self.images_total = 0
        # Batch-shape buckets: at dispatch time the smallest shape
        # covering the gathered requests runs, so a shallow queue pays a
        # small batch instead of the full padded one: the low-traffic p50
        # lever (a fill-1 request on batch 64 otherwise computes 64 slots
        # to answer 1).
        self.buckets = resolve_buckets(engine, buckets)
        self.bucket_batches = {b: 0 for b in self.buckets}
        # Load-aware bucket choice: a small dispatch at saturation wastes an
        # in-flight slot on few requests. The gathered-fill EWMA is the load
        # signal: the bucket must cover margin x recent fill, not just this
        # gather, so a brief queue dip under sustained load cannot downshift
        # the batch shape. alpha 0.25 ~= 5-dispatch memory; margin 1.5 keeps
        # fill-4 traffic on a bucket of 8. The JAX package's values.
        self.fill_ewma = 0.0
        self.fill_alpha = 0.25
        self.bucket_margin = 1.5
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="sr-batch-dispatch", daemon=True)
        self._fetcher = threading.Thread(
            target=self._fetch_loop, name="sr-batch-fetch", daemon=True)
        self._dispatcher.start()
        self._fetcher.start()

    def submit(self, x: np.ndarray) -> Future:
        if tuple(x.shape) != self.input_shape or x.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 input of shape {self.input_shape}, "
                f"got {x.dtype} {tuple(x.shape)}")
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("server is shutting down")
            if len(self._items) >= self.max_queue:
                raise QueueFullError(
                    f"request queue full ({self.max_queue} pending)")
            self._items.append((x, fut))
            self._cond.notify()
        return fut

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._items)

    def _pick_bucket(self, n_got: int) -> int:
        """Smallest bucket shape covering BOTH this gather and the recent
        load (margin x fill EWMA); only the dispatcher thread calls this."""
        self.fill_ewma += self.fill_alpha * (n_got - self.fill_ewma)
        want = max(n_got, int(math.ceil(self.fill_ewma * self.bucket_margin)))
        for b in self.buckets:
            if b >= want:
                return b
        return self.buckets[-1]

    def _dispatch_loop(self) -> None:
        bs = self.engine.batch_size
        while True:
            with self._cond:
                while not self._items and not self._closed:
                    self._cond.wait()
                if not self._items and self._closed:
                    self._inflight.put(None)  # fetcher shutdown sentinel
                    return
                got = [self._items.popleft()]
                # Latency-bounded fill: hold the batch open briefly for
                # concurrent requests to coalesce (the bucket runs padded
                # either way, so filling real slots is free throughput).
                deadline = time.monotonic() + self.max_wait
                while len(got) < bs:
                    while not self._items and not self._closed:
                        left = deadline - time.monotonic()
                        if left <= 0 or not self._cond.wait(timeout=left):
                            break
                    if not self._items:
                        break
                    while self._items and len(got) < bs:
                        got.append(self._items.popleft())
            futures = [f for _, f in got]
            bucket = self._pick_bucket(len(got))
            try:
                stacked = np.stack([x for x, _ in got])
                handle = self.engine.dispatch(stacked, bucket=bucket)
            except Exception as exc:  # noqa: BLE001 - propagate to callers
                for f in futures:
                    f.set_exception(exc)
                continue
            self.batches_total += 1
            self.images_total += len(got)
            self.bucket_batches[bucket] += 1
            self._inflight.put((futures, handle))  # blocks at `depth`

    def _fetch_loop(self) -> None:
        while True:
            entry = self._inflight.get()
            if entry is None:
                return
            futures, handle = entry
            try:
                out = self.engine.fetch(handle)
            except Exception as exc:  # noqa: BLE001 - propagate to callers
                for f in futures:
                    f.set_exception(exc)
                continue
            for i, f in enumerate(futures):
                f.set_result(out[i])

    def close(self) -> None:
        """Stop accepting work, drain queued/in-flight batches, join threads."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._dispatcher.join()
        self._fetcher.join()


class ServeStats:
    """Lock-protected request counters + a latency ring for quantiles."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.errors_total = 0
        self._lat: deque = deque(maxlen=window)

    def reset(self) -> None:
        """Zero counters and the latency ring (e.g. after a warm-up phase)."""
        with self._lock:
            self.requests_total = 0
            self.errors_total = 0
            self._lat.clear()

    def record(self, latency_s: float, error: bool) -> None:
        with self._lock:
            self.requests_total += 1
            if error:
                self.errors_total += 1
            else:
                self._lat.append(latency_s)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            n = len(lat)
            q = lambda p: round(1000 * lat[min(n - 1, int(p * n))], 2) if n else None
            return {
                "requests_total": self.requests_total,
                "errors_total": self.errors_total,
                "latency_ms": {"p50": q(0.50), "p95": q(0.95), "count": n},
            }


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Bound socket reads (request line / headers / body): a stalled client
    # otherwise parks a handler thread forever and blocks shutdown join.
    timeout = 65.0

    def log_message(self, fmt, *args):  # route access logs away from stderr spam
        if self.server.ctx.get("verbose"):
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str = "application/json",
              headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: dict) -> None:
        self._send(code, json.dumps(obj).encode() + b"\n")

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        ctx = self.server.ctx
        if self.path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "model": ctx["model_type"],
                "n_lr_images": ctx["n_frames"],
                "batch_size": ctx["batcher"].engine.batch_size,
                "buckets": ctx["batcher"].buckets,
                "platform": ctx["platform"],
                "artifact": ctx.get("artifact"),
                "reload_generation": ctx.get("reloads", 0),
            })
        elif self.path == "/stats":
            batcher = ctx["batcher"]
            snap = ctx["stats"].snapshot()
            snap.update({
                "batches_total": batcher.batches_total,
                "images_batched": batcher.images_total,
                "mean_batch_fill": round(
                    batcher.images_total / batcher.batches_total, 2)
                if batcher.batches_total else None,
                "queue_depth": batcher.queue_depth(),
                "batches_by_bucket": {str(k): v for k, v
                                      in batcher.bucket_batches.items()},
                "fill_ewma": round(batcher.fill_ewma, 2),
            })
            self._send_json(200, snap)
        elif self.path == "/metrics":
            # Prometheus text exposition (production scrape target; the
            # JSON twin at /stats stays for humans/scripts).
            batcher = ctx["batcher"]
            snap = ctx["stats"].snapshot()
            lat = snap["latency_ms"]
            lines = [
                "# TYPE sr_requests_total counter",
                f"sr_requests_total {snap['requests_total']}",
                "# TYPE sr_errors_total counter",
                f"sr_errors_total {snap['errors_total']}",
                "# TYPE sr_batches_total counter",
                f"sr_batches_total {batcher.batches_total}",
                "# TYPE sr_images_batched_total counter",
                f"sr_images_batched_total {batcher.images_total}",
                "# TYPE sr_queue_depth gauge",
                f"sr_queue_depth {batcher.queue_depth()}",
                "# TYPE sr_bucket_batches_total counter",
                *[f'sr_bucket_batches_total{{bucket="{b}"}} {n}'
                  for b, n in batcher.bucket_batches.items()],
                "# TYPE sr_reload_generation gauge",
                f"sr_reload_generation {ctx.get('reloads', 0)}",
            ]
            for name, val in (("p50", lat["p50"]), ("p95", lat["p95"])):
                if val is not None:
                    lines += [f"# TYPE sr_latency_ms_{name} gauge",
                              f"sr_latency_ms_{name} {val}"]
            self._send(200, ("\n".join(lines) + "\n").encode(),
                       ctype="text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
        if self.path == "/admin/reload":
            self._handle_reload()
            return
        if self.path != "/v1/sr":
            # Body left unread: drop the connection rather than letting the
            # next keep-alive request parse it as a request line.
            self.close_connection = True
            self._send_json(404, {"error": "not found"})
            return
        ctx = self.server.ctx
        t0 = time.perf_counter()
        code, body, ctype, headers = self._handle_sr(ctx)
        ctx["stats"].record(time.perf_counter() - t0, error=code >= 400)
        self._send(code, body, ctype, headers)

    def _handle_reload(self) -> None:
        """POST /admin/reload {"artifact": path} — zero-downtime rollover.

        Token-gated: the endpoint pretends not to exist without a configured
        --admin-token (defense in depth next to the usual deploy-behind-
        localhost posture), and constant-time-compares X-Admin-Token.
        """
        import hmac

        ctx = self.server.ctx
        token = ctx.get("admin_token")
        if not token:
            self.close_connection = True
            self._send_json(404, {"error": "not found"})
            return
        got = self.headers.get("X-Admin-Token") or ""
        if not hmac.compare_digest(got.encode(), str(token).encode()):
            self.close_connection = True
            self._send_json(403, {"error": "bad admin token"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            artifact = body["artifact"]
        except (ValueError, KeyError):
            self.close_connection = True
            self._send_json(400, {"error": 'expected {"artifact": "path"}'})
            return
        try:
            result = reload_engine(ctx, artifact)
        except Exception as exc:  # noqa: BLE001 — old engine still serving
            self._send_json(409, {"error": f"reload failed, previous engine "
                                           f"still serving: {exc}"})
            return
        self._send_json(200, result)

    def _handle_sr(self, ctx) -> Tuple[int, bytes, str, Optional[dict]]:
        from .utils.imgio import encode_png_bytes, read_png_bytes
        from .utils.infer_utils import format_s2naip_data

        def err(code, msg):
            return code, json.dumps({"error": msg}).encode() + b"\n", \
                "application/json", None

        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self.close_connection = True  # unread body would desync keep-alive
            return err(400, "bad Content-Length")
        if length <= 0:
            self.close_connection = True
            return err(411, "Content-Length required")
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            return err(413, f"body exceeds {MAX_BODY_BYTES} bytes")
        data = self.rfile.read(length)
        try:
            # Pixel cap checked from the PNG header BEFORE decompression:
            # a 16 MB body can inflate to hundreds of MB decoded, and the
            # queue-based backpressure only engages after decode.
            arr = read_png_bytes(data, max_pixels=MAX_IMAGE_PIXELS)
        except Exception:  # noqa: BLE001 - malformed client input
            return err(400, "body is not a decodable PNG within "
                            f"{MAX_IMAGE_PIXELS} pixels")
        n = ctx["n_frames"]
        if arr.ndim != 3 or arr.shape[1] != 32 or arr.shape[2] != 3 \
                or arr.shape[0] % 32 != 0:
            return err(400, f"expected a [T*32, 32, 3] PNG, got {arr.shape}")
        if arr.shape[0] // 32 < n:
            return err(400, f"need >= {n} frames, got {arr.shape[0] // 32}")
        # Frame selection is seeded per request (config manual_seed):
        # identical request bytes always produce identical outputs.
        stacked, _ = format_s2naip_data(
            arr, n, rng=np.random.RandomState(ctx["seed"]))
        try:
            try:
                fut = ctx["batcher"].submit(stacked)
            except RuntimeError as first:
                # hot-reload race: this thread read the old batcher right
                # before a swap closed it — re-read once; the new engine is
                # already warm and serving
                if isinstance(first, QueueFullError):
                    raise
                fut = ctx["batcher"].submit(stacked)
        except QueueFullError:
            return err(503, "server overloaded")
        except RuntimeError as exc:
            return err(503, str(exc))
        try:
            out = fut.result(timeout=ctx["timeout_s"])
        except futures.TimeoutError:  # alias of builtin TimeoutError on 3.11+
            return err(504, "inference timed out")
        except Exception as exc:  # noqa: BLE001 - device-side failure
            return err(500, f"inference failed: {exc}")
        if "application/octet-stream" in (self.headers.get("Accept") or ""):
            return 200, out.tobytes(), "application/octet-stream", \
                {"X-Shape": ",".join(map(str, out.shape)), "X-Dtype": "uint8"}
        return 200, encode_png_bytes(out), "image/png", None


def _build_engine(opt: dict, batch_size: Optional[int], artifact: Optional[str],
                  warmup: bool, buckets=None, device="cuda"):
    """Engine + model_type from a config (or a .ssrx artifact). Shared by
    startup and hot reload; raises (leaving live traffic untouched on the
    reload path) when the artifact doesn't fit the serving contract."""
    n_frames = int(opt["n_lr_images"])
    if artifact:
        from .export import ExportedEngine

        # Symbolic-batch artifacts have no pinned batch: fall back to the
        # config's batch_size (same precedence the non-artifact branch uses)
        # before ExportedEngine's default of 64. Fixed-batch artifacts keep
        # their pin — the config default never conflicts with it.
        engine = ExportedEngine(artifact, batch_size=batch_size,
                                default_batch_size=opt.get("batch_size"), device=device)
        if engine.n_frames != n_frames:
            raise ValueError(
                f"artifact expects n_lr_images={engine.n_frames}, the config "
                f"says {n_frames}")
        dims = engine.meta["input_dims"]
        if dims[-3] != 32 or dims[-2] != 32:
            raise ValueError(
                f"serving needs a 32x32-window artifact, got input dims {dims}")
        model_type = engine.meta["model_type"]
    else:
        from .infer import load_infer_variables
        from .inference import InferenceEngine
        from .utils.model_utils import build_network, uses_3d_input

        model = build_network(opt, device="cpu")
        engine = InferenceEngine(
            model, load_infer_variables(opt, model),
            batch_size=int(batch_size or opt.get("batch_size", 64)),
            use_3d=uses_3d_input(opt["network_g"]["type"]), n_frames=n_frames,
            matmul_precision=str(opt.get("matmul_precision", "highest")),
            device=device,
        )
        model_type = opt["network_g"]["type"]
    input_shape = (32, 32, n_frames * 3)
    if warmup:
        # Run EVERY bucket shape before accepting traffic (or swapping an
        # engine under traffic): the kernel library's first load, weight
        # packing and cuDNN's plans for each shape happen here, not in a
        # request.
        for b in resolve_buckets(engine, buckets):
            engine.fetch(engine.dispatch(
                np.zeros((b,) + input_shape, np.uint8), bucket=b))
    return engine, model_type, input_shape


def reload_engine(ctx: dict, artifact: str) -> dict:
    """Zero-downtime engine swap: build + warm the new artifact's engine,
    atomically publish a NEW MicroBatcher, then drain and close the old one.

    In-flight and already-queued requests complete on the OLD engine (its
    fetcher resolves their futures before join); every request admitted
    after the swap runs the new weights. Failures anywhere before the swap
    leave the serving engine untouched. Serialized by ctx['reload_lock'].
    """
    with ctx["reload_lock"]:
        old = ctx["batcher"]
        engine, model_type, input_shape = _build_engine(
            ctx["opt"], ctx["batch_size"], artifact, warmup=True,
            buckets=ctx.get("buckets"), device=ctx.get("device", "cuda"))
        new = MicroBatcher(engine, input_shape,
                           max_wait_ms=old.max_wait * 1000.0,
                           max_queue=old.max_queue,
                           depth=old._inflight.maxsize,
                           buckets=ctx.get("buckets"))
        ctx["batcher"] = new  # atomic publish: handlers read ctx once/request
        ctx["model_type"] = model_type
        ctx["artifact"] = artifact
        ctx["reloads"] = ctx.get("reloads", 0) + 1
        old.close()  # drains the old queue; old futures resolve normally
        return {"status": "reloaded", "artifact": artifact,
                "model": model_type, "generation": ctx["reloads"],
                "batch_size": engine.batch_size}


def build_server(opt: dict, host: str = "127.0.0.1", port: int = 8000,
                 batch_size: Optional[int] = None, max_wait_ms: float = 5.0,
                 max_queue: int = 512, depth: int = 2, timeout_s: float = 60.0,
                 warmup: bool = True, verbose: bool = False,
                 artifact: Optional[str] = None,
                 admin_token: Optional[str] = None,
                 buckets=None, device="cuda"):
    """Construct (server, batcher): model + engine + micro-batcher + HTTP.

    `artifact` serves a `.ssrx` export (export.py) instead of building the
    model: the host runs the exact traced programs the artifact holds, with
    no model code or checkpoint import on the serving path. The config
    still supplies n_lr_images / manual_seed; the artifact's own fixed batch
    wins over the config's batch_size. `admin_token` enables POST
    /admin/reload (zero-downtime rollover). `device` is where the engine
    runs (default cuda; raises without a card).
    """
    from .device import resolve_device

    device = resolve_device(device)
    n_frames = int(opt["n_lr_images"])
    engine, model_type, input_shape = _build_engine(
        opt, batch_size, artifact, warmup, buckets=buckets, device=device)
    batcher = MicroBatcher(engine, input_shape, max_wait_ms=max_wait_ms,
                           max_queue=max_queue, depth=depth, buckets=buckets)

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: concurrent clients
        # beyond that get TCP resets before accept() ever runs. Size it to
        # the application queue so overload surfaces as a clean 503 from
        # submit(), not a connection reset.
        request_queue_size = max(128, max_queue)
        # Non-daemon handler threads + block_on_close: server_close() joins
        # in-flight handlers, so a SIGTERM drain flushes every computed
        # response to its client instead of killing writers mid-send.
        # _Handler.timeout bounds how long a stalled client can hold a join.
        daemon_threads = False
        block_on_close = True

    server = _Server((host, port), _Handler)
    server.ctx = {
        "batcher": batcher,
        "stats": ServeStats(),
        "n_frames": n_frames,
        "seed": int(opt.get("manual_seed") or 0),
        "timeout_s": float(timeout_s),
        "model_type": model_type,
        "platform": engine.device.type,
        "verbose": verbose,
        # hot-reload machinery (reload_engine): the original opt/batch_size
        # rebuild future engines; admin_token gates the HTTP endpoint
        "opt": opt,
        "batch_size": batch_size,
        "artifact": artifact,
        "admin_token": admin_token,
        "buckets": buckets,  # original spec; reloads re-resolve it
        "device": device,
        "reload_lock": threading.Lock(),
        "reloads": 0,
    }
    return server, batcher


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-opt", type=str, required=True,
                        help="Path to an infer-style options yml.")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--buckets", type=str, default="auto",
                        help="Comma-separated batch-shape buckets run "
                             "next to the full batch; the smallest shape "
                             "covering each gathered micro-batch runs "
                             "('auto' = one small bucket of batch/8 — the "
                             "low-traffic latency lever; 'none' = single "
                             "full-batch shape).")
    parser.add_argument("--max_wait_ms", type=float, default=5.0)
    parser.add_argument("--queue_limit", type=int, default=512)
    parser.add_argument("--timeout_s", type=float, default=60.0)
    parser.add_argument("--no_warmup", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--artifact", type=str, default=None,
                        help="Serve a .ssrx export (satlas_sr_tpu_torch.export) "
                             "instead of building the model from the config.")
    parser.add_argument("--admin-token", type=str, default=None,
                        help="Enable POST /admin/reload (zero-downtime .ssrx "
                             "rollover), authenticated by X-Admin-Token.")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from .utils.lint import report_lint
    from .utils.options import yaml_load

    # No compilation cache to enable (the JAX daemon's persistent XLA
    # cache): the port compiles nothing per process except its kernels,
    # built once into build/ at first use.
    opt = yaml_load(args.opt)
    report_lint(opt, "infer")
    buckets = parse_buckets_arg(args.buckets)
    server, batcher = build_server(
        opt, host=args.host, port=args.port, batch_size=args.batch_size,
        max_wait_ms=args.max_wait_ms, max_queue=args.queue_limit,
        timeout_s=args.timeout_s, warmup=not args.no_warmup,
        verbose=args.verbose, artifact=args.artifact,
        admin_token=args.admin_token, buckets=buckets, device=args.device)

    import signal

    def _stop(signum, frame):
        # shutdown() must come from another thread than serve_forever's.
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)

    if args.artifact:
        # rollout without HTTP: atomically replace the .ssrx on disk, then
        # `kill -HUP <pid>` — same zero-downtime swap as /admin/reload
        def _hup(signum, frame):
            def _do():
                try:
                    result = reload_engine(server.ctx, server.ctx["artifact"])
                    print(f"SIGHUP reload ok: {result}", flush=True)
                except Exception as exc:  # noqa: BLE001 — keep serving old
                    print(f"SIGHUP reload failed (still serving previous "
                          f"engine): {exc}", flush=True)

            threading.Thread(target=_do, daemon=True).start()

        signal.signal(signal.SIGHUP, _hup)
    print(f"serving {server.ctx['model_type']} on "
          f"http://{server.server_address[0]}:{server.server_address[1]} "
          f"(batch buckets {batcher.buckets}, wait {args.max_wait_ms} ms)",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        # ctx["batcher"], not the startup local: reloads swap the live one
        server.ctx["batcher"].close()  # drain queued work before exiting
        print("server stopped; queue drained.", flush=True)


if __name__ == "__main__":
    main()

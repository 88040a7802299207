"""Batched inference engine on one card.

Counterpart of satlas_sr_tpu/inference.py:
- one uint8 -> uint8 program: uint8 NHWC batch in -> /255 -> generator ->
  clamp -> *255 -> uint8 out with TRUNCATION (the reference infer CLI does
  (output * 255).astype(np.uint8) with no rounding). Host<->device traffic
  is uint8 and quantisation runs on the device.
- a fixed batch size, with the last partial batch padded;
- `use_3d` models (SRCNN, HighResNet) get the channel-stacked batch as
  [B, T, H, W, C] revisits and return [B, 1, H', W', C'], of which the
  engine keeps [B, H', W', C'];
- bfloat16 compute stores the weights in the compute dtype;
- `matmul_precision: highest` turns TF32 off for cuDNN convs and matmuls
  (both default to TF32 on Hopper), for parity with float32 references;
- dispatch/fetch overlap: a batch is copied from pinned host memory with a
  non_blocking copy on the engine's own CUDA stream, computed there, and
  copied back to pinned memory; `fetch` waits on that batch's event only.
- `dispatch(batch, bucket=...)` pads to a bucket's batch shape instead of
  the full batch (the serving daemon's batch-shape buckets); `round_bucket`
  gives the valid shape, any size up to the full batch on one card.
- `spatial_shards=S` (JAX's `InferenceEngine(spatial_shards=)`): the rows
  of every image split over the S ranks of this rank's space group
  (parallel/mesh.mesh_2d; every rank of the group calls with the same
  batch). `run(x)` keeps JAX's contract, the full host batch in and the
  full uint8 result out on every rank of the group: each rank copies only
  its band of input rows to its card, runs the model's `forward_band`
  (halo exchanges with the neighbour bands) and the uint8 output rows are
  all-gathered. `run_band(x_band)` takes and returns this rank's rows only.
  Rows that do not split (`band_rows` is None) run whole on every rank,
  the JAX package's replicated fallback.
The batch quantum is 1: one card a rank, and the data axis splits a
corpus, not a rank's batch.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .parallel import mesh
from .parallel.halo import gather_rows


#: the TF32 flags are process-wide: one holder at a time, so that two
#: engines on two threads (a hot reload warms the new engine while the old
#: one serves) cannot restore each other's setting mid-forward
_PRECISION_LOCK = threading.RLock()


@contextlib.contextmanager
def _precision(matmul_precision: str):
    """TF32 off for 'highest', allowed otherwise; restored on exit."""
    allow = matmul_precision != "highest"
    with _PRECISION_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def uint8_program(model: torch.nn.Module, dtype: torch.dtype,
                  x_uint8: torch.Tensor) -> torch.Tensor:
    """The engine's function: uint8 batch -> /255 in `dtype` -> model ->
    clamp -> *255 -> uint8, by truncation (the reference infer CLI's
    conversion)."""
    x = x_uint8.to(dtype) / 255.0
    y = model(x)
    if y.dim() == 5:  # [B, 1, H, W, C] from SRCNN/HighResNet
        y = y[:, 0]
    y = y.float().clamp(0.0, 1.0)
    return (y * 255.0).to(torch.uint8)


class UInt8Program(torch.nn.Module):
    """`uint8_program` as a module: what export.py traces."""

    def __init__(self, model: torch.nn.Module, dtype: torch.dtype):
        super().__init__()
        self.model, self.dtype = model, dtype

    def forward(self, x_uint8: torch.Tensor) -> torch.Tensor:
        return uint8_program(self.model, self.dtype, x_uint8)


class BatchRunner:
    """dispatch / fetch of a uint8 -> uint8 program on one device, at the
    full batch or a smaller bucket; shared by InferenceEngine and
    export.ExportedEngine. Subclasses give `_call(x, bucket)`.

    On CUDA a batch is padded on the host, copied from pinned memory with a
    non_blocking copy on the runner's own stream, computed there and copied
    back to pinned memory; `fetch` waits on that batch's event only. The
    serving daemon calls `dispatch` and `fetch` from two threads: the stream
    is made current per call (a thread-local setting), and the handle holds
    the pinned input and the device output until `fetch`.
    """

    def __init__(self, device: torch.device, batch_size: int, use_3d: bool,
                 n_frames: Optional[int], matmul_precision: str):
        self.device = device
        self.batch_size = batch_size
        self.use_3d = use_3d
        self.n_frames = n_frames
        self._precision = matmul_precision
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # the weights were written on this thread's current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _call(self, x: torch.Tensor, bucket: int) -> torch.Tensor:
        raise NotImplementedError

    def _band(self, batch: np.ndarray) -> Optional[tuple]:
        """[start, stop) of the rows of a prepared batch that this rank
        computes, or None for all of them (`_call_band` then runs them)."""
        return None

    def _call_band(self, x: torch.Tensor, bucket: int) -> torch.Tensor:
        raise NotImplementedError

    def round_bucket(self, b: int) -> int:
        """Smallest valid batch shape >= b, capped at the full batch (one
        card: any size is valid)."""
        return min(self.batch_size, max(1, int(b)))

    def _run(self, x: torch.Tensor, bucket: int, band: bool = False) -> torch.Tensor:
        with torch.inference_mode(), _precision(self._precision):
            return self._call_band(x, bucket) if band else self._call(x, bucket)

    def dispatch(self, batch_np: np.ndarray, bucket: Optional[int] = None):
        """Enqueue a batch padded to `bucket` (default: the full batch);
        returns an in-flight handle for `fetch`."""
        n = batch_np.shape[0]
        bucket = bucket or self.batch_size
        batch = prep_batch(batch_np, bucket, self.use_3d, self.n_frames)
        band = self._band(batch)
        if band is not None:  # this rank's rows only go to the card
            batch = batch[(slice(None),) * (batch.ndim - 3) + (slice(*band),)]
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if self._stream is None:
            return n, self._run(host, bucket, band is not None), None, None
        host = host.pin_memory()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            y = self._run(host.to(self.device, non_blocking=True), bucket, band is not None)
            out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            out.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        # the pinned input and the device output stay referenced until fetch
        return n, out, done, (host, y)

    def fetch(self, handle) -> np.ndarray:
        """Wait for a `dispatch` handle's result; strips the batch padding."""
        n, out, done, _ = handle
        if done is not None:
            done.synchronize()
        return out.numpy()[:n]

    def run(self, batch_np: np.ndarray) -> np.ndarray:
        """uint8 [B, H, W, T*C] -> uint8 [B, H_out, W_out, 3]."""
        return self.fetch(self.dispatch(batch_np))

    def run_many(self, batches: Iterable[np.ndarray], depth: int = 3) -> Iterable[np.ndarray]:
        """Pipelined execution: up to `depth` batches in flight."""
        return pipelined(self.dispatch, self.fetch, batches, depth)


class InferenceEngine(BatchRunner):
    """Runs the uint8-to-uint8 SR program at a fixed batch size on `device`,
    each image's rows split over a space group of `spatial_shards` ranks
    when that is > 1 (see the module docstring)."""

    def __init__(self, model: torch.nn.Module, variables: Optional[Dict[str, Any]] = None,
                 batch_size: int = 64, use_3d: bool = False, n_frames: Optional[int] = None,
                 matmul_precision: str = "highest", device="cuda", spatial_shards: int = 1):
        device = resolve_device(device)
        if spatial_shards > 1 and not hasattr(model, "forward_band"):
            raise ValueError(f"spatial_shards={spatial_shards}: {type(model).__name__} has "
                             "no row-band forward")
        #: this rank's space layout (parallel/mesh.mesh_2d), or None: rows whole
        self.space = mesh.mesh_2d(spatial_shards) if spatial_shards > 1 else None
        self.dtype = getattr(model, "dtype", torch.float32)
        if variables is not None:
            model.load_state_dict(variables)
        # inference only: weights live in the compute dtype (halves weight
        # reads at bf16); training keeps f32 master weights
        self.model = model.to(device=device, dtype=self.dtype).eval()
        super().__init__(device, batch_size, use_3d, n_frames, matmul_precision)

    def _call(self, x: torch.Tensor, bucket: int) -> torch.Tensor:
        return uint8_program(self.model, self.dtype, x)

    def band_rows(self, rows: int) -> Optional[tuple]:
        """[start, stop) of an image's `rows` that this rank computes, or
        None when they run whole: no space layout, or rows that do not make
        S equal bands, each a multiple of the model's row factor and holding
        its halo (`band_rows` of the model)."""
        if self.space is None:
            return None
        s = self.space.space_size
        factor, least = self.model.band_rows
        if rows % (s * factor) or rows // s < least:
            return None
        return self.space.band(rows)

    def _band(self, batch: np.ndarray) -> Optional[tuple]:
        return self.band_rows(batch.shape[-3])

    def _band_program(self, x: torch.Tensor) -> torch.Tensor:
        return uint8_program(lambda t: self.model.forward_band(t, self.space), self.dtype, x)

    def _call_band(self, x: torch.Tensor, bucket: int) -> torch.Tensor:
        return gather_rows(self._band_program(x), self.space)

    def run_band(self, band_np: np.ndarray) -> np.ndarray:
        """This rank's band of rows of a batch, uint8 [B, h, W, T*C] ->
        its rows of the result [B, h*scale, W*scale, 3]; every rank of the
        space group calls it with its own band (`band_rows`)."""
        n = band_np.shape[0]
        host = torch.from_numpy(np.ascontiguousarray(prep_batch(
            band_np, self.batch_size, self.use_3d, self.n_frames)))
        with contextlib.ExitStack() as ctx:
            if self._stream is not None:
                ctx.enter_context(torch.cuda.device(self.device))
                ctx.enter_context(torch.cuda.stream(self._stream))
            ctx.enter_context(torch.inference_mode())
            ctx.enter_context(_precision(self._precision))
            return self._band_program(host.to(self.device)).cpu().numpy()[:n]


def prep_batch(batch_np: np.ndarray, batch_size: int, use_3d: bool = False,
               n_frames: Optional[int] = None) -> np.ndarray:
    """Pad to the batch size with copies of the first image; for `use_3d`,
    [B, H, W, T*C] -> [B, T, H, W, C] (T = n_frames, or T*C // 3)."""
    n = batch_np.shape[0]
    if n < batch_size:
        pad = np.repeat(batch_np[:1], batch_size - n, axis=0)
        batch_np = np.concatenate([batch_np, pad], axis=0)
    if use_3d and batch_np.ndim == 4:
        b, h, w, tc = batch_np.shape
        t = n_frames or tc // 3
        batch_np = batch_np.reshape(b, h, w, t, tc // t).transpose(0, 3, 1, 2, 4)
    return batch_np


def pipelined(dispatch, fetch, batches: Iterable[np.ndarray], depth: int = 3):
    """Generic in-flight window: up to `depth` dispatched batches pending."""
    pending: deque = deque()
    for b in batches:
        pending.append(dispatch(b))
        if len(pending) >= max(1, depth):
            yield fetch(pending.popleft())
    while pending:
        yield fetch(pending.popleft())


def batched(items: Sequence, batch_size: int) -> List[Sequence]:
    return [items[i: i + batch_size] for i in range(0, len(items), batch_size)]


def prefetch_map(pool, fn, items: Iterable, depth: int = 3):
    """Map `fn` over `items` on `pool`, keeping up to `depth` tasks in flight;
    results come back in order."""
    import itertools

    it = iter(items)
    in_flight = deque(pool.submit(fn, x) for x in itertools.islice(it, depth))
    while in_flight:
        fut = in_flight.popleft()
        for x in itertools.islice(it, 1):
            in_flight.append(pool.submit(fn, x))
        yield fut.result()


class BoundedWriter:
    """Async writes with backpressure: at most `max_pending` in flight, so a
    slow disk caps host memory and write errors surface near where they
    happen."""

    def __init__(self, pool, max_pending: int = 32):
        self._pool = pool
        self._max = max(1, max_pending)
        self._pending: deque = deque()

    def submit(self, fn, *args) -> None:
        if len(self._pending) >= self._max:
            self._pending.popleft().result()
        self._pending.append(self._pool.submit(fn, *args))

    def drain(self) -> None:
        while self._pending:
            self._pending.popleft().result()

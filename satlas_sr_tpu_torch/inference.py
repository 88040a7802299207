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
No mesh: one card.
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device


@contextlib.contextmanager
def _precision(matmul_precision: str):
    """TF32 off for 'highest', allowed otherwise; restored on exit."""
    allow = matmul_precision != "highest"
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class InferenceEngine:
    """Runs the uint8-to-uint8 SR program at a fixed batch size on `device`."""

    def __init__(self, model: torch.nn.Module, variables: Optional[Dict[str, Any]] = None,
                 batch_size: int = 64, use_3d: bool = False, n_frames: Optional[int] = None,
                 matmul_precision: str = "highest", device="cuda"):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.use_3d = use_3d
        self.n_frames = n_frames
        self.dtype = getattr(model, "dtype", torch.float32)
        if variables is not None:
            model.load_state_dict(variables)
        # inference only: weights live in the compute dtype (halves weight
        # reads at bf16); training keeps f32 master weights
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self._precision = matmul_precision
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # weights were written on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    @torch.inference_mode()
    def _run(self, x_uint8: torch.Tensor) -> torch.Tensor:
        with _precision(self._precision):
            x = x_uint8.to(self.dtype) / 255.0
            y = self.model(x)
            if y.dim() == 5:  # [B, 1, H, W, C] from SRCNN/HighResNet
                y = y[:, 0]
            y = y.float().clamp(0.0, 1.0)
            # truncation, not rounding: the reference infer CLI's conversion
            return (y * 255.0).to(torch.uint8)

    def dispatch(self, batch_np: np.ndarray):
        """Enqueue a batch; returns an in-flight handle for `fetch`."""
        n = batch_np.shape[0]
        host = torch.from_numpy(np.ascontiguousarray(prep_batch(
            batch_np, self.batch_size, self.use_3d, self.n_frames)))
        if self._stream is None:
            return n, self._run(host), None, None
        host = host.pin_memory()
        with torch.cuda.stream(self._stream):
            y = self._run(host.to(self.device, non_blocking=True))
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

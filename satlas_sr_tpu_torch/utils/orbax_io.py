"""The `train.checkpoint_backend: orbax` backend on torch.distributed.checkpoint
(DCP), behind the JAX package's `utils/orbax_io.py` names.

What the backend buys over the native one (utils/checkpoint.py), as in the
JAX package:
- async commit: `save()` copies the tensors to host memory and returns; the
  write drains on DCP's background thread while training continues;
- atomic directory commits: a step is written into
  `<step>.orbax-checkpoint-tmp-<ns>` and renamed to `<step>` as soon as its
  write completed (a callback of the write's future), so a kill mid-save
  never shows up in discovery (the torn-write tolerance the native backend
  gets from its crc footer).

Layout: `{training_states}/orbax/<step>/` holding DCP's `.metadata` and
`__0_0.distcp`. One self-contained payload a step: {"epoch", "iter",
"state", "nets": {name: {param key: state dict}}}, so a consumer needs no
companion file. The training state is replicated on every rank, so rank 0
writes it alone, with no collective (`no_dist`), as the native backend
does; every rank restores from the committed directory. The JAX package's
orbax roots (tensorstore) are a different format: the port reads the JAX
trainer's native `.state` / `.msgpack` files instead.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

TMP_TAG = ".orbax-checkpoint-tmp-"


def committed_steps(root: str):
    """Sorted committed steps under `root`: its pure-digit directories."""
    if not os.path.isdir(root):
        return []
    return sorted(int(n) for n in os.listdir(root)
                  if n.isdigit() and os.path.isdir(os.path.join(root, n)))


def latest_committed_step(root: str) -> Optional[int]:
    """The newest committed step under `root`, read without importing DCP
    (train.py's resume discovery runs before the model exists). In-flight
    writes carry the tmp suffix until their commit rename."""
    steps = committed_steps(root)
    return steps[-1] if steps else None


def is_dcp_step(path: str) -> bool:
    """Whether `path` is a step directory this backend wrote (DCP's metadata
    file, which an orbax/tensorstore step does not have)."""
    return os.path.isfile(os.path.join(path, ".metadata"))


def read_metadata(path: str):
    """DCP's metadata of a step directory: keys, tensor sizes and dtypes."""
    from torch.distributed.checkpoint import FileSystemReader

    return FileSystemReader(path).read_metadata()


class OrbaxCheckpointIO:
    """Save, discover and restore DCP steps under `root`, one write in flight."""

    def __init__(self, root: str, async_save: bool = True):
        self.root = os.path.abspath(root)
        self.async_save = bool(async_save)
        self._pending = None  # (future, committed event, error box) of the write in flight
        os.makedirs(self.root, exist_ok=True)
        # a process exiting mid-drain must not tear the write; a last resort
        # only: `wait()` is the drain point that raises
        atexit.register(self._wait_at_exit)

    def save(self, step: int, payload: Dict[str, Any]) -> None:
        """Write `payload` as `step` (after the write in flight has landed)."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        final = os.path.join(self.root, str(int(step)))
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} already committed at {final}")
        tmp = f"{final}{TMP_TAG}{time.time_ns()}"
        writer = dcp.FileSystemWriter(tmp)
        if not self.async_save:
            dcp.save(payload, storage_writer=writer, no_dist=True)
            os.rename(tmp, final)
            return
        # async_save stages the tensors to host memory before it returns
        future = dcp.async_save(payload, storage_writer=writer, no_dist=True)
        committed, error = threading.Event(), []

        def commit(fut):
            try:
                if fut.exception() is None:
                    os.rename(tmp, final)
            except Exception as e:  # raised by wait()
                error.append(e)
            finally:
                committed.set()

        self._pending = (future, committed, error)
        future.add_done_callback(commit)

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_committed_step(self.root)

    def restore(self, step: Optional[int] = None) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(step, payload) of `step` (default: the latest committed), or None
        when there is none. The tree comes back from DCP's metadata alone,
        tensors on the CPU; dict keys as strings (an optimizer's per-param
        state keys included), lists and other values as saved."""
        from torch.distributed.checkpoint import FileSystemReader
        from torch.distributed.checkpoint.default_planner import _EmptyStateDictLoadPlanner
        from torch.distributed.checkpoint.state_dict_loader import _load_state_dict

        self.wait()
        step = latest_committed_step(self.root) if step is None else int(step)
        if step is None:
            return None
        payload: Dict[str, Any] = {}
        # DCP's public load fills a given template; this metadata-driven load
        # is the one its format converter (dcp_to_torch_save) uses
        _load_state_dict(payload, storage_reader=FileSystemReader(os.path.join(self.root, str(step))),
                         planner=_EmptyStateDictLoadPlanner(), no_dist=True)
        return step, payload

    def wait(self) -> None:
        """Block until the write in flight has landed and been committed. A
        failed background write raises here (DCP's CheckpointException, its
        cause in the message): a preemption save must not exit cleanly and
        auto-resume from a stale step."""
        if self._pending is None:
            return
        future, committed, error = self._pending
        self._pending = None
        future.result()
        committed.wait()
        if error:
            raise error[0]

    def _wait_at_exit(self) -> None:
        from torch.distributed.checkpoint.api import CheckpointException  # a BaseException

        try:
            self.wait()
        except (Exception, CheckpointException) as e:  # interpreter teardown: report
            print(f"[orbax] WARNING: checkpoint drain at exit failed: {e!r}", file=sys.stderr)

    def close(self) -> None:
        atexit.unregister(self._wait_at_exit)
        self.wait()

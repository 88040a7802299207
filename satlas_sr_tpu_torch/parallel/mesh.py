"""Data parallelism across processes (the JAX package's `parallel/mesh.py`).

The JAX package runs one program over a device mesh and lets XLA insert the
collectives: the batch-sharded train step's gradient mean, the global loss
means, the cross-process sums of validation. The port runs one process a
rank, each holding its own rows on its own device (`device.resolve_device`:
cuda:LOCAL_RANK), and makes those collectives itself through
torch.distributed (group set up by `utils/options.init_distributed`):

- `all_reduce_mean_`: the gradient mean of the batch-sharded step, one
  flattened float32 bucket a network, one all_reduce, divided by the world
  size (once a step, after the accumulated micro-batches);
- `mean_across_processes`: the loss logs' global means (reduce_loss_dict);
- `sum_across_processes`: validation's host accumulators, in float64;
- `broadcast_bytes`: rank 0's bytes to every rank (the resume decision);
- `is_main_process`, `local_shard_indices` (EnlargedSampler's round robin).
Collectives run on the rank's card under NCCL and on CPU tensors under gloo
(gloo's CUDA all_reduce stages through the host).

No counterpart: `data_mesh`, `batch_sharding`, `replicated`,
`replicate_tree`, `shard_batch`, `shard_microbatches`, `shard_rows_padded`
and `local_rows`. Each rank holds only its rows, so there is no global array
to pad, shard or reassemble. The 'space' row sharding (`mesh_2d`,
`spatial_sharding`, `space_axis_is_process_local`) needs a row-band halo
exchange around every convolution and is the next slice (ROADMAP queue 1
item 14).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

#: set to a list to record (tag, start, end) CUDA events around each gradient
#: all_reduce (chip_smoke times the collective with them)
REDUCE_EVENTS: Optional[List] = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def collective_device() -> torch.device:
    """Where the small collectives' tensors live: the rank's card under NCCL
    (which takes no CPU tensors), the CPU otherwise."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_shard_indices(total: int, shard: int, num_shards: int) -> List[int]:
    """Round-robin indices for per-process data sharding (EnlargedSampler analog)."""
    return list(range(shard, total, num_shards))


def gather_across_processes(vec) -> np.ndarray:
    """Every rank's small host vector, as float64 rows [world, n] in rank order."""
    v = np.asarray(vec, np.float64).reshape(-1)
    n = world_size()
    if n == 1:
        return v[None]
    t = torch.from_numpy(np.ascontiguousarray(v)).to(collective_device())
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t)
    return np.stack([p.cpu().numpy() for p in parts])


def sum_across_processes(vec) -> np.ndarray:
    """Element-wise float64 sum of a small host vector over all processes.

    The vectors are all-gathered and summed on the host in rank order, so
    every rank gets the same bits whatever order the backend reduces in.
    The JAX package moves each value as a float32 (hi, lo) pair because its
    allgather drops float64 to float32; torch carries float64 as it is."""
    rows = gather_across_processes(vec)
    total = rows[0].copy()
    for row in rows[1:]:
        total += row
    return total


def broadcast_bytes(data: Optional[bytes], src: int = 0) -> bytes:
    """Rank `src`'s bytes on every rank (each rank passes its own; only the
    source's are read)."""
    if world_size() == 1:
        return data or b""
    dev = collective_device()
    raw = np.frombuffer(data or b"", np.uint8)
    size = torch.tensor([raw.size], dtype=torch.int64, device=dev)
    dist.broadcast(size, src)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=dev)
    if rank() == src and raw.size:
        buf.copy_(torch.from_numpy(raw.copy()))
    dist.broadcast(buf, src)
    return bytes(buf.cpu().numpy())


@torch.no_grad()
def all_reduce_mean_(params: Iterable[torch.Tensor], tag: str = "grads") -> None:
    """Gradients -> their mean over the ranks, in place: one flattened
    float32 bucket, one all_reduce (sum), divided by the world size. Every
    rank gets the same bits, so replicas stay equal after the optimizer."""
    n = world_size()
    grads = [p.grad for p in params if p.grad is not None]
    if n == 1 or not grads:
        return
    if REDUCE_EVENTS is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat.div_(n)
    torch._foreach_copy_(grads, [c.view_as(g) for c, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])
    if REDUCE_EVENTS is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        REDUCE_EVENTS.append((tag, start, end))


@torch.no_grad()
def mean_across_processes(logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A dict of scalar tensors -> their means over the ranks (the JAX step's
    global means; basicsr's reduce_loss_dict), in one all_reduce."""
    n = world_size()
    if n == 1 or not logs:
        return logs
    keys = sorted(logs)
    flat = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    flat.div_(n)
    return {k: flat[i] for i, k in enumerate(keys)}

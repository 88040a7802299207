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

The 'space' row sharding on the inference path (`mesh_2d`,
`space_axis_is_process_local`, `mesh_axis_size`): the world's ranks form
world/S data groups of S consecutive ranks, and a space group splits an
image's rows into S bands, one a rank, with a row-band halo exchange
around every convolution (parallel/halo.py; the band forwards of
archs/rrdbnet, srcnn and highresnet). XLA's SPMD pass inserts those
exchanges in the JAX package; the port writes them. On the inference
path rows that do not split evenly run whole on every rank of the group
(the JAX package's replicated fallback). The trainers (`spatial_shards`
in a train yml) run their G and D steps on the rank's band and refuse a
layout they cannot split; the collectives are differentiable, and the
step's world mean of the gradients (`all_reduce_mean_`) is the sum over
the space group and the mean over the data groups (models/base.py, "Row
bands"). `data_coords` gives a rank's data group before the groups exist
(the loaders are built first).

No counterpart: `data_mesh`, `batch_sharding`, `spatial_sharding`,
`replicated`, `replicate_tree`, `shard_batch`, `shard_microbatches`,
`shard_rows_padded` and `local_rows`. Each rank holds only its rows, so
there is no global array to pad, shard or reassemble: a band's rows are
sliced on the host (`SpaceLayout.band`) and gathered back with
`halo.gather_rows`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

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


class SpaceLayout(NamedTuple):
    """This rank's place in the ('data', 'space') layout of `mesh_2d`."""

    space_index: int   # this rank's band, top to bottom
    space_size: int    # S: the bands an image's rows split into
    data_index: int    # this rank's data group
    data_size: int     # world / S data groups
    group: Optional["dist.ProcessGroup"]  # the space group (None when S == 1)
    ranks: Tuple[int, ...]  # the space group's global ranks, in space order

    def band(self, rows: int) -> Tuple[int, int]:
        """[start, stop) of this rank's rows of `rows` (S must divide it)."""
        if rows % self.space_size:
            raise ValueError(f"{rows} rows do not split into {self.space_size} bands")
        step = rows // self.space_size
        return self.space_index * step, (self.space_index + 1) * step


def mesh_axis_size(layout: SpaceLayout, name: str, default: int = 1) -> int:
    """The size of the layout's 'data' or 'space' axis (`default` for another name)."""
    return {"data": layout.data_size, "space": layout.space_size}.get(name, default)


def space_axis_is_process_local(spatial: int) -> bool:
    """True iff every space group of `spatial` consecutive ranks lies on one
    host. torchrun and SLURM number a host's ranks consecutively, so that
    holds when `spatial` divides the ranks on this host (LOCAL_WORLD_SIZE;
    the whole world when unset)."""
    from ..utils.options import local_world_size

    return local_world_size(world_size()) % spatial == 0


def data_coords(spatial: int) -> Tuple[int, int]:
    """(data_index, data_size) of this rank in `mesh_2d(spatial)`'s layout,
    without making its groups: the ranks of a data group load the same rows,
    so the loaders shard by data group."""
    world = world_size()
    if spatial < 1 or world % spatial:
        hint = "" if is_initialized() else ": start S ranks through --launcher"
        raise ValueError(f"spatial={spatial} must divide the process count {world}{hint}")
    return rank() // spatial, world // spatial


def mesh_2d(spatial: int) -> SpaceLayout:
    """The ('data', 'space') layout: world/S data groups of S = `spatial`
    consecutive ranks, each group splitting an image's rows into S bands.

    Every rank must call it, with the same `spatial`: it makes one process
    group a data group (`dist.new_group`, every group on every rank, in the
    same order). Raises ValueError when S does not divide the world (one
    process without a launcher: any S > 1), and when a space group would
    span hosts (the JAX package's support-or-refuse: a configured row split
    is never dropped)."""
    world, me = world_size(), rank()
    d, _ = data_coords(spatial)
    if spatial > 1 and not space_axis_is_process_local(spatial):
        from ..utils.options import local_world_size

        raise ValueError(
            f"spatial sharding ({spatial} shards) spans process boundaries: a space group "
            f"of {spatial} ranks would span hosts with {local_world_size(world)} rank(s) a "
            "host; pick spatial_shards that divides the ranks on each host")
    group = None
    if spatial > 1:
        for g in range(world // spatial):
            ranks = list(range(g * spatial, (g + 1) * spatial))
            made = dist.new_group(ranks)
            if me in ranks:
                group = made
    return SpaceLayout(me % spatial, spatial, d, world // spatial, group,
                       tuple(range(d * spatial, (d + 1) * spatial)))


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

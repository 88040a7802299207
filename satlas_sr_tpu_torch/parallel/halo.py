"""Row-band halo exchange between the ranks of a space group.

What XLA's collective-permutes do for the JAX package's row-sharded convs
(parallel/mesh.py mesh_2d, spatial_sharding): an image's rows are split
into S bands, one a rank of the space group (`mesh.mesh_2d`), and before
each convolution a rank takes the rows its receptive field reaches from
the bands above and below.

- `exchange_rows(x, n, space)`: this rank's band with `n` rows of each
  neighbour's band around it, none on a side that is the image's true
  border (the first band's top, the last band's bottom). Both directions
  go in one `dist.batch_isend_irecv`, so no order of the ranks can
  deadlock.
- `gather_rows(x, space)`: every band's rows, in space order, on every
  rank of the group (one all_gather).

Under NCCL the tensors stay on the card and the collectives are ordered
on the caller's current stream (the inference engine runs on its own).
Under gloo point-to-point and all_gather take CPU tensors only, so a band
on the card is staged through the host (as `mesh.collective_device` does
for the small collectives): correct, not fast.

`EXCHANGE_EVENTS` times the exchanges: set it to a list and each
exchange appends (host seconds, bytes sent, start and end CUDA events on
the card or None).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import SpaceLayout

#: set to a list to record (host seconds, bytes sent, start, end) of each
#: exchange_rows call (CUDA events on a card, else None)
EXCHANGE_EVENTS: Optional[List] = None


def _staged(t: torch.Tensor, space: SpaceLayout) -> torch.Tensor:
    """`t` where the group's backend takes it: as it is under NCCL, on the
    host otherwise (gloo)."""
    if t.is_cuda and dist.get_backend(space.group) != "nccl":
        return t.cpu()
    return t


def exchange_rows(x: torch.Tensor, n: int, space: Optional[SpaceLayout],
                  dim: int = 1) -> Tuple[torch.Tensor, int, int]:
    """(x_ext, top, bottom): the band x (rows along `dim`: 1 for NHWC, 2
    for NCHW) with `top` rows of the band above before it and `bottom` rows
    of the band below after it. Each is `n`, or 0 at the image's true
    border and for a group of one. The neighbours' bands must hold `n`
    rows."""
    if space is None or space.space_size == 1 or n == 0:
        return x, 0, 0
    if x.shape[dim] < n:
        raise ValueError(f"a band of {x.shape[dim]} rows cannot give a halo of {n}")
    i, s = space.space_index, space.space_size
    t0 = time.perf_counter()
    start = end = None
    if EXCHANGE_EVENTS is not None and x.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    ops, recv, sent = [], {}, 0
    for side, peer, rows in (("top", i - 1, x.narrow(dim, 0, n)),
                             ("bottom", i + 1, x.narrow(dim, x.shape[dim] - n, n))):
        if not 0 <= peer < s:
            continue
        send = _staged(rows.contiguous(), space)
        recv[side] = torch.empty_like(send)
        sent += send.numel() * send.element_size()
        ops += [dist.P2POp(dist.isend, send, space.ranks[peer], space.group),
                dist.P2POp(dist.irecv, recv[side], space.ranks[peer], space.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    parts = [recv["top"].to(x.device)] if "top" in recv else []
    parts.append(x)
    if "bottom" in recv:
        parts.append(recv["bottom"].to(x.device))
    out = torch.cat(parts, dim)
    if EXCHANGE_EVENTS is not None:
        if end is not None:
            end.record()
        EXCHANGE_EVENTS.append((time.perf_counter() - t0, sent, start, end))
    return out, n * ("top" in recv), n * ("bottom" in recv)


def gather_rows(x: torch.Tensor, space: Optional[SpaceLayout], dim: int = 1) -> torch.Tensor:
    """Every rank's band of the group, concatenated along `dim` in space
    order, on x's device (the bands must have one shape)."""
    if space is None or space.space_size == 1:
        return x
    send = _staged(x.contiguous(), space)
    parts = [torch.empty_like(send) for _ in range(space.space_size)]
    dist.all_gather(parts, send, group=space.group)
    return torch.cat(parts, dim).to(x.device)

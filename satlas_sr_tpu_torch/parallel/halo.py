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
- `all_reduce_sum(x, space)`: the sum of every band's x over the group.
- `pad_rows` and `conv2d_band`: a band padded with its neighbours' rows (or
  the image's own padding on its border), and a zero-padded conv on it.
- `reflect_pad(x, before, after, dim)`: a whole image reflect-padded along
  any axis (torch's mode='reflect'), by narrow + flip + cat: the port's one
  reflect pad. Its backward adds the border rows' gradient, flipped, onto
  the rows they copy, in a fixed order: F.pad's reflect backward
  accumulates with atomics on the card (four addends at a corner), so a
  train run through it would not repeat.

All three are differentiable (autograd Functions, taken when autograd
records), each backward the adjoint of its forward, so a train step's
backward through row bands is one collective program too:
- the exchange's backward sends the gradient of the `top` halo rows back
  to the band above and of the `bottom` rows to the band below, and adds
  what the neighbours send into this band's own edge rows (one
  batch_isend_irecv, as the forward);
- the gather's backward sums every rank's gradient of the gathered image
  over the group (an all_reduce) and keeps this band's rows: the
  reduce-scatter, the adjoint of the all_gather;
- the sum's backward is the sum of the gradients (an all_reduce).
So a term that every rank of the group computes whole from gathered or
summed values (the OSM objects, the CLIP loss, a Gram matrix) reaches each
band S times, once from each rank: the train step's gradient mean over
the world divides it by S (models/base.py, "Row bands"), which counts it
once. Every rank of the group must run the same differentiable
collectives in the same order; the autograd engine walks identical graphs
in one order, so the backward's collectives pair up.

Under NCCL the tensors stay on the card and the collectives are ordered
on the caller's current stream (the inference engine runs on its own).
Under gloo point-to-point and all_gather take CPU tensors only, so a band
on the card is staged through the host (as `mesh.collective_device` does
for the small collectives): correct, not fast.

`EXCHANGE_EVENTS` times the forward exchanges and `EXCHANGE_BACKWARD_EVENTS`
their backwards: set one to a list and each exchange appends (host
seconds, bytes sent, start and end CUDA events on the card or None).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import SpaceLayout

#: set to a list to record (host seconds, bytes sent, start, end) of each
#: exchange_rows forward (CUDA events on a card, else None)
EXCHANGE_EVENTS: Optional[List] = None
#: the same record of each exchange's backward
EXCHANGE_BACKWARD_EVENTS: Optional[List] = None


def _staged(t: torch.Tensor, space: SpaceLayout) -> torch.Tensor:
    """`t` where the group's backend takes it: as it is under NCCL, on the
    host otherwise (gloo)."""
    if t.is_cuda and dist.get_backend(space.group) != "nccl":
        return t.cpu()
    return t


def _swap(sends, space: SpaceLayout, record: Optional[List], device) -> dict:
    """Send each (peer offset, rows) of `sends` to the band at that offset
    and receive the same shape back from it, all in one batch_isend_irecv:
    {offset: received rows on `device`}."""
    t0 = time.perf_counter()
    start = end = None
    if record is not None and device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    ops, recv, sent = [], {}, 0
    for offset, rows in sends:
        peer = space.space_index + offset
        send = _staged(rows.contiguous(), space)
        recv[offset] = torch.empty_like(send)
        sent += send.numel() * send.element_size()
        ops += [dist.P2POp(dist.isend, send, space.ranks[peer], space.group),
                dist.P2POp(dist.irecv, recv[offset], space.ranks[peer], space.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = {offset: t.to(device) for offset, t in recv.items()}
    if record is not None:
        if end is not None:
            end.record()
        record.append((time.perf_counter() - t0, sent, start, end))
    return out


def _sides(n: int, space: SpaceLayout) -> Tuple[int, int]:
    """(top, bottom) halo rows of this rank's band: n, or 0 at the image's border."""
    i, s = space.space_index, space.space_size
    return n * (i > 0), n * (i < s - 1)


def _exchange(x: torch.Tensor, n: int, space: SpaceLayout, dim: int) -> torch.Tensor:
    top, bottom = _sides(n, space)
    sends = ([(-1, x.narrow(dim, 0, n))] if top else []) + \
        ([(1, x.narrow(dim, x.shape[dim] - n, n))] if bottom else [])
    recv = _swap(sends, space, EXCHANGE_EVENTS, x.device)
    parts = ([recv[-1]] if top else []) + [x] + ([recv[1]] if bottom else [])
    return torch.cat(parts, dim)


class _ExchangeRows(torch.autograd.Function):
    """exchange_rows under autograd; the backward is the adjoint exchange."""

    @staticmethod
    def forward(ctx, x, n, space, dim):
        ctx.n, ctx.space, ctx.dim, ctx.rows = n, space, dim, x.shape[dim]
        return _exchange(x, n, space, dim)

    @staticmethod
    def backward(ctx, g):
        n, space, dim, h = ctx.n, ctx.space, ctx.dim, ctx.rows
        top, bottom = _sides(n, space)
        # the halo rows' gradient goes back to the band that sent them
        sends = ([(-1, g.narrow(dim, 0, top))] if top else []) + \
            ([(1, g.narrow(dim, top + h, bottom))] if bottom else [])
        recv = _swap(sends, space, EXCHANGE_BACKWARD_EVENTS, g.device)
        dx = g.narrow(dim, top, h).clone()
        if top:  # the band above's bottom halo is this band's first n rows
            dx.narrow(dim, 0, n).add_(recv[-1])
        if bottom:
            dx.narrow(dim, h - n, n).add_(recv[1])
        return dx, None, None, None


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def exchange_rows(x: torch.Tensor, n: int, space: Optional[SpaceLayout],
                  dim: int = 1) -> Tuple[torch.Tensor, int, int]:
    """(x_ext, top, bottom): the band x (rows along `dim`: 1 for NHWC, 2
    for NCHW) with `top` rows of the band above before it and `bottom` rows
    of the band below after it. Each is `n`, or 0 at the image's true
    border and for a group of one. The neighbours' bands must hold `n`
    rows. Differentiable (see the module docstring)."""
    if space is None or space.space_size == 1 or n == 0:
        return x, 0, 0
    if x.shape[dim] < n:
        raise ValueError(f"a band of {x.shape[dim]} rows cannot give a halo of {n}")
    top, bottom = _sides(n, space)
    if _records(x):
        return _ExchangeRows.apply(x, n, space, dim), top, bottom
    return _exchange(x, n, space, dim), top, bottom


def _gather(x: torch.Tensor, space: SpaceLayout, dim: int) -> torch.Tensor:
    send = _staged(x.contiguous(), space)
    parts = [torch.empty_like(send) for _ in range(space.space_size)]
    dist.all_gather(parts, send, group=space.group)
    return torch.cat(parts, dim).to(x.device)


def _all_reduce(x: torch.Tensor, space: SpaceLayout) -> torch.Tensor:
    t = _staged(x.contiguous(), space).clone()
    dist.all_reduce(t, group=space.group)
    return t.to(x.device)


class _GatherRows(torch.autograd.Function):
    """gather_rows under autograd; the backward is the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, space, dim):
        ctx.space, ctx.dim, ctx.rows = space, dim, x.shape[dim]
        return _gather(x, space, dim)

    @staticmethod
    def backward(ctx, g):
        h = ctx.rows
        total = _all_reduce(g, ctx.space)
        return total.narrow(ctx.dim, ctx.space.space_index * h, h).contiguous(), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space):
        ctx.space = space
        return _all_reduce(x, space)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.space), None


def gather_rows(x: torch.Tensor, space: Optional[SpaceLayout], dim: int = 1) -> torch.Tensor:
    """Every rank's band of the group, concatenated along `dim` in space
    order, on x's device (the bands must have one shape). Differentiable."""
    if space is None or space.space_size == 1:
        return x
    if _records(x):
        return _GatherRows.apply(x, space, dim)
    return _gather(x, space, dim)


def all_reduce_sum(x: torch.Tensor, space: Optional[SpaceLayout]) -> torch.Tensor:
    """x summed over the ranks of the space group, on every rank. Differentiable."""
    if space is None or space.space_size == 1:
        return x
    if _records(x):
        return _AllReduceSum.apply(x, space)
    return _all_reduce(x, space)


def _border_rows(x: torch.Tensor, k: int, dim: int, border: str, first: bool) -> torch.Tensor:
    """The `k` rows the image's padding puts before (first) or after its
    rows: zeros, the reflection (no edge repeat) or the edge row repeated."""
    h = x.shape[dim]
    if border == "zeros":
        shape = list(x.shape)
        shape[dim] = k
        return x.new_zeros(shape)
    if border == "reflect":
        rows = x.narrow(dim, 1, k) if first else x.narrow(dim, h - 1 - k, k)
        return rows.flip(dim) if k > 1 else rows
    if border == "edge":
        edge = x.narrow(dim, 0 if first else h - 1, 1)
        return torch.cat([edge] * k, dim) if k > 1 else edge
    raise ValueError(f"border must be 'zeros', 'reflect' or 'edge', got {border!r}")


def _reflect_pad(x: torch.Tensor, before: int, after: int, dim: int) -> torch.Tensor:
    parts = [x]
    if before:
        parts.insert(0, _border_rows(x, before, dim, "reflect", True))
    if after:
        parts.append(_border_rows(x, after, dim, "reflect", False))
    # contiguous, as F.pad's CUDA reflect writes it: a channels-last input
    # (SRCNN's revisit stack) would otherwise send the convs after the pad
    # to other cuDNN algorithms than the band path's
    return torch.cat(parts, dim).contiguous()


class _ReflectPad(torch.autograd.Function):
    """reflect_pad under autograd. The backward folds the padded rows'
    gradient back onto the rows they copy: the inner rows' gradient, then
    each border's rows flipped and added to rows [1, before] and
    [h - 1 - after, h - 1), in that order (no scatter; two small adds
    where autograd of the forward would build and sum three full-size
    gradients)."""

    @staticmethod
    def forward(ctx, x, before, after, dim):
        ctx.args = before, after, dim, x.shape[dim]
        return _reflect_pad(x, before, after, dim)

    @staticmethod
    def backward(ctx, g):
        before, after, dim, h = ctx.args
        gx = g.narrow(dim, before, h).clone()
        for k, src, dst in ((before, 0, 1), (after, before + h, h - 1 - after)):
            if k:
                rows = g.narrow(dim, src, k)
                gx.narrow(dim, dst, k).add_(rows.flip(dim) if k > 1 else rows)
        return gx, None, None, None


def reflect_pad(x: torch.Tensor, before: int, after: int, dim: int) -> torch.Tensor:
    """x with `before` and `after` reflected rows (no edge repeat) along
    `dim`: F.pad(mode='reflect') of that axis, bit for bit."""
    if not (before or after):
        return x
    if _records(x):
        return _ReflectPad.apply(x, before, after, dim)
    return _reflect_pad(x, before, after, dim)


def pad_rows(x: torch.Tensor, above: int, below: int, space: Optional[SpaceLayout],
             dim: int = 1, border: str = "zeros") -> torch.Tensor:
    """x with `above` rows before it and `below` after it along `dim`: the
    neighbour bands' rows (exchange_rows) where there is a neighbour, and on
    the image's true border the rows `border` pads with ('zeros',
    'reflect', 'edge'). With no space layout: the whole image padded."""
    n = max(above, below)
    ext, top, _ = exchange_rows(x, n, space, dim)
    bottom_halo = ext.shape[dim] - top - x.shape[dim]
    parts = []
    if above:
        parts.append(ext.narrow(dim, top - above, above) if top
                     else _border_rows(x, above, dim, border, True))
    parts.append(x)
    if below:
        parts.append(ext.narrow(dim, top + x.shape[dim], below) if bottom_halo
                     else _border_rows(x, below, dim, border, False))
    return torch.cat(parts, dim) if len(parts) > 1 else x


def conv2d_band(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                space: Optional[SpaceLayout], stride: int = 1, padding: int = 1) -> torch.Tensor:
    """F.conv2d(x, weight, bias, stride, padding) of NCHW x (zero padding)
    on this rank's row band: `padding` rows above and kh - padding - stride
    below from the neighbour bands, zero rows on the image's border. The
    band's rows must divide by the stride, so its output rows are the whole
    output's rows [start / stride, stop / stride)."""
    if x.shape[2] % stride:
        raise ValueError(f"a band of {x.shape[2]} rows does not split at stride {stride}")
    kh = weight.shape[-2]
    x = pad_rows(x, padding, kh - padding - stride, space, dim=2)
    return F.conv2d(x, weight, bias, stride=stride, padding=(0, padding))

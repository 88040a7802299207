"""ResidualDenseBlock as a hand-written CUDA kernel (csrc/rdb.cu).

Replaces `satlas_sr_tpu/ops/pallas/rdb.py:129 rdb_pallas`, which runs one
whole RDB, x + 0.2 * x5 with x_{k+1} = lrelu_0.2(conv3x3_k(concat(x,
x_1 .. x_k))), over NHWC tensors. The port computes the same function; it
does not carry over the TPU kernel's VMEM tiling: the RDB of one 32x32 image
(32*32*192*2 B = 393 KB in bf16) does not fit in the 227 KB of shared memory
a Hopper block can have.

What bounds it on an H100: at esrgan_8S2 width (nf=64, g=32) and B=64 one
call does 2*B*32*32*9*26624 = 31.4 GFLOP and must move x in and out once
(16.8 MB in bf16, 33.6 MB in f32), so it is compute-bound in both dtypes:
about 32 us at the 989 TFLOP/s bf16 tensor-core peak; in f32, 0.19 ms for
the three TF32 products per f32 product at the 495 TFLOP/s TF32 peak (0.47
ms at the 67 TFLOP/s of plain FP32 FMAs, the old direct kernel's ceiling).
At batch 1 the same call is 490.7 MFLOP, 0.5 us at the bf16 peak: there
what bounds a route is how many SMs it reaches and its fixed costs.

Two routes (`Route`), chosen by `rdb_route` from the shape alone:
- "bands": five launches over a channels-last dense-concat buffer
  [B, H, W, nf + 4g]; launch k reads channels [0, nf + k*g) and writes its
  own (see the head of csrc/rdb.cu, design A). Each conv is an implicit GEMM
  on the tensor cores (wgmma, f32 accumulation) over 8-row x TW-column
  output bands, fed by TMA band loads and bulk weight copies through a
  3-stage ring, one producer warp and two consumer warpgroups. nf and g must
  be 32 or 64 (the wgmma widths, WGMMA_N).
  - bfloat16 (TW 32): wgmma k16 with both operands read from shared memory;
    weights packed to [cin/16, 9, 2, cout, 8], the image the B descriptor
    reads.
  - float32 (TW 32, 16 or 8): three TF32 products per f32 product (hi*hi +
    lo*hi + hi*lo, where hi = tf32(v), lo = tf32(v - hi)), which keeps f32
    accuracy where one TF32 product would not. Weights are split on the host
    (`round_tf32`) and packed to [cin/8, 9, 2, 2*cout, 4], hi and lo stacked
    along N; the band is split in registers and fed as wgmma's A operand. A
    block runs alone on its SM, so the route takes the narrowest band whose
    blocks run in one wave: a 32x32 image runs on 16 SMs at TW 8, not 4 at
    TW 32.
- "cluster" (bfloat16, nf 64, g 32): the whole RDB in one launch, one
  thread-block cluster an image, each block holding its 8 x TW band of the
  whole concat in shared memory for all five convs, the halos exchanged over
  distributed shared memory after each conv (design B). x is read by TMA
  from x itself: no concat buffer, no copy of x, unless the caller keeps
  the concat (training). The weights stream through each block's own ring
  from L2: multicasting them to the cluster ran slower (the slowest block
  then paces every ring).
Weights are packed once per module and dtype (`pack_weights`).

`rdb` takes the plain version (`rdb_reference`) only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises. `LAUNCHES` counts
its kernel calls (one per RDB and op call, whichever route), training
forwards included. Outside autograd it goes through `rdb_op`, the PyTorch op
`satlas_sr_torch::rdb` (torch.library: the kernel on CUDA, the plain version
on the CPU, an empty_like fake for tracing), so torch.export keeps the RDB
whole and an exported program launches the kernel (export.py; the frozen
weights of `archs/rrdbnet.FrozenRDB`).

Training (`RDBFunction`, taken by `rdb` when autograd records): the forward
is the same kernel, and it keeps the concat buffer [B, H, W, nf + 4g] it
fills anyway: x, x1..x4, exactly the operands the five convs read, in x's
dtype. The backward (`rdb_backward`) needs no recompute: five cuDNN conv
gradients over slices of that buffer, walked from conv5 down, with the
LeakyReLU's slope read off the sign of the saved x_k (its sign is its
input's, since the slope 0.2 > 0). The JAX kernel has no backward (its
trainer runs the XLA graph), so this is stock ops outside the ported kernel.
On the CPU the Function's forward is `rdb_reference_with_concat`, which
fills the same buffer, so the CPU tests run the backward the card runs.

The two 0.2s (the LeakyReLU's slope and the residual's scale) are 0.2 in
x's dtype (`point_two`: 0.2001953125 in bfloat16), as the JAX block's
constants are: a weakly typed 0.2 and jnp.asarray(0.2, x5.dtype) take the
bf16 network's dtype there.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

#: input channels per pipeline stage, one 32-byte wgmma k-step (k16 in
#: bf16, k8 in tf32), and the output widths (wgmma N) the kernel is built for
KC = {torch.bfloat16: 16, torch.float32: 8}
WGMMA_N = (32, 64)
#: the card's SMs (H100 SXM), which a band route's blocks should fill
SMS = 132
#: band widths the routes are built for, and the most blocks a cluster takes
BAND_WIDTHS = {"bands": {torch.float32: (32, 16, 8), torch.bfloat16: (32,)},
               "cluster": {torch.bfloat16: (16, 8)}}
MAX_CLUSTER = 16

#: kernel calls (one per RDB) since the last reset; the plain version does
#: not count
LAUNCHES = 0
#: the same calls by kernel: "<f32|bf16>/<route><tw>" (`route_key`) -> count;
#: reset with .clear()
ROUTE_LAUNCHES: collections.Counter = collections.Counter()
#: RDBFunction backwards (`rdb_backward` calls) since the last reset
BACKWARDS = 0

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=None)
def point_two(dtype: torch.dtype) -> float:
    """0.2 rounded to `dtype`: the JAX RRDBNet's LeakyReLU slope and residual
    scale in a network of that compute dtype (0.2001953125 in bfloat16;
    float32's 0.2 is what a Python 0.2 becomes in a float32 op)."""
    return float(torch.tensor(0.2, dtype=dtype))


class PackedRDB(NamedTuple):
    """Weights of one RDB in the kernel's layout."""

    weights: List[torch.Tensor]  # conv k, in x's dtype: see packed_shape
    bias: torch.Tensor           # [4g + nf] float32, conv1..conv5 concatenated


def rdb_reference(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor], nf: int, g: int,
                  c: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch RDB: x [B, H, W, nf] NHWC -> [B, H, W, nf].

    kernels[k] is conv k's OIHW weight [g or nf, nf + k*g, 3, 3] and biases[k]
    its bias; both are cast to x's dtype, as the JAX block casts them. `c`,
    the slope and residual scale, defaults to point_two(x.dtype) (a float32
    reference of the bf16 kernel passes point_two(torch.bfloat16)).
    """
    if x.shape[-1] != nf:
        raise ValueError(f"x has {x.shape[-1]} channels, expected nf={nf}")
    c = point_two(x.dtype) if c is None else c
    h = x.permute(0, 3, 1, 2)
    feats = [h]
    for k in range(5):
        y = F.conv2d(torch.cat(feats, dim=1), kernels[k].to(x.dtype),
                     biases[k].to(x.dtype), padding=1)
        if k < 4:
            feats.append(F.leaky_relu(y, c))
    return (y * c + h).permute(0, 2, 3, 1).contiguous()


def rdb_reference_with_concat(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                              biases: Sequence[torch.Tensor], nf: int, g: int):
    """`rdb_reference`, also returning the dense-concat buffer
    [B, H, W, nf + 4g] (x, x1..x4 in x's dtype) that the kernel fills."""
    if x.shape[-1] != nf:
        raise ValueError(f"x has {x.shape[-1]} channels, expected nf={nf}")
    b, h, w, _ = x.shape
    buf = x.new_empty((b, h, w, nf + 4 * g))
    buf[..., :nf] = x
    cat = buf.permute(0, 3, 1, 2)
    c = point_two(x.dtype)
    for k in range(5):
        cin = nf + k * g
        y = F.conv2d(cat[:, :cin], kernels[k].to(x.dtype), biases[k].to(x.dtype), padding=1)
        if k < 4:
            cat[:, cin:cin + g] = F.leaky_relu(y, c)
    out = (y * c + x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
    return out, buf


def rdb_backward(buf: torch.Tensor, g_out: torch.Tensor, kernels: Sequence[torch.Tensor],
                 nf: int, g: int):
    """Gradients of one RDB from its saved concat buffer.

    buf [B, H, W, nf + 4g] holds x, x1..x4 (the forward's conv operands), g_out
    [B, H, W, nf] the gradient of the output. Returns (dx [B, H, W, nf],
    [dW_1..dW_5] each in its kernel's dtype, [db_1..db_5] float32). The convs
    run in buf's dtype on channels-last views; the gradient of the concat
    accumulates in float32.
    """
    dt = buf.dtype
    c = point_two(dt)
    cat = buf.permute(0, 3, 1, 2)
    gout = g_out.permute(0, 3, 1, 2)
    g_cat = torch.zeros(buf.shape, dtype=torch.float32, device=buf.device).permute(0, 3, 1, 2)
    g_cat[:, :nf] = gout  # the residual
    g_z = (gout.float() * c).to(dt)  # gradient of conv5's output
    dws, dbs = [None] * 5, [None] * 5
    for k in range(4, -1, -1):
        cin = nf + k * g
        w = kernels[k]
        g_in, g_w, _ = torch.ops.aten.convolution_backward(
            g_z, cat[:, :cin], w.to(dt), None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False])
        dws[k] = g_w.to(w.dtype)
        dbs[k] = g_z.float().sum((0, 2, 3))
        g_cat[:, :cin] += g_in
        if k:  # x_k = lrelu(z_k) sits at channels [nf + (k-1)g, nf + kg)
            lo = nf + (k - 1) * g
            slope = torch.where(cat[:, lo:lo + g] > 0, 1.0, c)
            g_z = (g_cat[:, lo:lo + g] * slope).to(dt)
    dx = g_cat[:, :nf].permute(0, 2, 3, 1).to(g_out.dtype).contiguous()
    return dx, dws, dbs


def round_tf32(w: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero: the bit arithmetic of tf32_bits in csrc/rdb.cu."""
    bits = w.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def packed_shape(k: int, nf: int, g: int, dtype: torch.dtype) -> tuple:
    """Shape of conv k's packed weight for the kernel of `dtype`: per
    pipeline stage (KC input channels) and tap, the K-major core matrices
    (8 rows x 16 bytes) of wgmma's B operand, two along K.

    bfloat16: [cin/16, 9, 2, cout, 8], element [j, t, h, n, e] = W[n, 16j +
    8h + e, t // 3, t % 3].
    float32: [cin/8, 9, 2, 2*cout, 4], element [j, t, h, n, e] =
    hi(W[n, 8j + 4h + e, t // 3, t % 3]) for n < cout and lo(W[n - cout, ...])
    for n >= cout, with hi = round_tf32(W) and lo = round_tf32(W - hi).
    """
    cout, cin = (g if k < 4 else nf), nf + k * g
    rows = 2 * cout if dtype == torch.float32 else cout
    return (cin // KC[dtype], 9, 2, rows, KC[dtype] // 2)


def pack_weights(kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 nf: int, g: int, dtype: torch.dtype) -> PackedRDB:
    """OIHW conv weights -> the `dtype` kernel's layout (`packed_shape`);
    biases -> f32."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the rdb kernel takes float32 or bfloat16, got {dtype}")
    if nf not in WGMMA_N or g not in WGMMA_N:
        raise ValueError(f"the rdb kernel needs nf and g in {WGMMA_N}, got nf={nf}, g={g}")
    ws = []
    for k, w in enumerate(kernels):
        cout, cin = (g if k < 4 else nf), nf + k * g
        if tuple(w.shape) != (cout, cin, 3, 3):
            raise ValueError(f"conv{k + 1} weight {tuple(w.shape)}, expected {(cout, cin, 3, 3)}")
        w = w.detach().reshape(cout, cin, 9)
        if dtype == torch.float32:  # hi rows, then lo rows, along N
            hi = round_tf32(w)
            w = torch.cat([hi, round_tf32(w.float() - hi)])
        kc = KC[dtype]
        w = w.reshape(len(w), cin // kc, 2, kc // 2, 9).permute(1, 4, 2, 0, 3)
        ws.append(w.to(dtype).contiguous())
    bias = torch.cat([b.detach().reshape(-1) for b in biases]).float().contiguous()
    return PackedRDB(ws, bias)


class Route(NamedTuple):
    """Which kernel runs an RDB call: "bands" (five launches over 8 x tw
    bands) or "cluster" (one launch, one cluster of 8 x tw bands an image)."""

    kernel: str
    tw: int


def route_key(dtype: torch.dtype, route: Route) -> str:
    """ROUTE_LAUNCHES's key of `route` in `dtype`, e.g. "bf16/cluster8"."""
    return f"{_KERNEL_DTYPES[dtype]}/{route.kernel}{route.tw}"


def _bands(h: int, w: int, tw: int) -> int:
    """8-row x tw-column bands of one h x w image."""
    return -(-h // 8) * -(-w // tw)


@functools.lru_cache(maxsize=None)
def rdb_route(b: int, h: int, w: int, dtype: torch.dtype, nf: int = 64, g: int = 32) -> Route:
    """The route for x [b, h, w, nf]: a pure function of the shape, chosen
    from chip_smoke.py's times of both routes on an H100 (PERF.md's kernel
    table), never a fallback: the route it names raises if it cannot run.

    bfloat16: the cluster route for nf 64, g 32 where an image is at most
    MAX_CLUSTER bands and the batch's blocks take at most half the card's
    SMS: TW 8 where they do at that width (batch <= 4 at 32x32), else TW 16
    (batch <= 8). A cluster's blocks must share one GPC, so the card holds
    only 7-15 such clusters at once (cluster_capacity): batch 16 at TW 16
    runs in two waves and loses to the five launches. The five-launch route
    otherwise: batch 16 and up, the 512-wide tiles and bands.
    float32: the five-launch route at the narrowest band width whose blocks
    run in one wave on the SMS, or the widest when none does.
    """
    if dtype == torch.bfloat16:
        if (nf, g) == (64, 32):
            for tw in (8, 16):
                if _bands(h, w, tw) <= MAX_CLUSTER and b * _bands(h, w, tw) <= SMS // 2:
                    return Route("cluster", tw)
        return Route("bands", 32)
    widths = BAND_WIDTHS["bands"][torch.float32]
    for tw in reversed(widths):
        if b * _bands(h, w, tw) <= SMS:
            return Route("bands", tw)
    return Route("bands", widths[0])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/rdb.cu's library with every entry's argument and return types
    bound, built on first use."""
    from .build import load

    lib = load("rdb")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("ssr_rdb_forward_f32", "ssr_rdb_forward_bf16"):
        getattr(lib, name).argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.ssr_rdb_cluster_bf16.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
    lib.ssr_rdb_cluster_capacity.argtypes = [i32, i32]
    for name in ("ssr_rdb_forward_f32", "ssr_rdb_forward_bf16", "ssr_rdb_cluster_bf16",
                 "ssr_rdb_cluster_capacity"):
        getattr(lib, name).restype = i32
    lib.ssr_cuda_error_string.argtypes = [i32]
    lib.ssr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cluster_capacity(tw: int, n: int) -> int:
    """Clusters of n blocks of the cluster route at band width tw that the
    current card holds at once (cudaOccupancyMaxActiveClusters)."""
    got = _library().ssr_rdb_cluster_capacity(tw, n)
    if got < 0:
        raise RuntimeError(f"cluster capacity query failed: {_error(-got)}")
    return got


def _error(code: int) -> str:
    return _library().ssr_cuda_error_string(code).decode()


@functools.lru_cache(maxsize=None)
def _packed_shapes(nf: int, g: int, dtype: torch.dtype) -> Tuple[tuple, ...]:
    return tuple(packed_shape(k, nf, g, dtype) for k in range(5))


def _launch(x: torch.Tensor, packed: PackedRDB, nf: int, g: int, keep_concat: bool = False,
            route: Optional[Route] = None):
    """One kernel call: the output, and with keep_concat the concat buffer
    too, as (out, buf). `route` (default `rdb_route` of x's shape) names
    the kernel; chip_smoke.py and the card's tests pass it to run both
    routes at one shape."""
    global LAUNCHES
    b, h, w, _ = x.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit of 65535")
    if not x.is_contiguous():
        raise ValueError("rdb kernel needs a contiguous NHWC tensor")
    if any(t.device != x.device or t.dtype != x.dtype for t in packed.weights) \
            or packed.bias.device != x.device:
        raise ValueError("packed weights must be on x's device and in x's dtype")
    if packed.bias.dtype != torch.float32:
        raise ValueError("packed bias must be float32")
    # pack_weights made these shapes; the op also takes tensors it did not
    # make (an exported program's), so one tuple compare stays
    if tuple(tuple(t.shape) for t in packed.weights) != _packed_shapes(nf, g, x.dtype):
        raise ValueError(f"packed weights do not fit nf={nf}, g={g} in {x.dtype}: "
                         "pack_weights(..., nf, g, x.dtype)")
    route = route or rdb_route(b, h, w, x.dtype, nf, g)
    if route.tw not in BAND_WIDTHS[route.kernel].get(x.dtype, ()):
        raise ValueError(f"no {route.kernel} route of band width {route.tw} for {x.dtype}")
    lib = _library()
    weights = [t.data_ptr() for t in packed.weights]
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route.kernel == "cluster":
            buf = (torch.empty((b, h, w, nf + 4 * g), dtype=x.dtype, device=x.device)
                   if keep_concat else None)
            err = lib.ssr_rdb_cluster_bf16(x.data_ptr(), *weights, packed.bias.data_ptr(),
                                           out.data_ptr(), None if buf is None else buf.data_ptr(),
                                           b, h, w, nf, g, route.tw, stream)
        else:
            buf = torch.empty((b, h, w, nf + 4 * g), dtype=x.dtype, device=x.device)
            buf[..., :nf].copy_(x)
            fn = (lib.ssr_rdb_forward_f32 if x.dtype == torch.float32
                  else lib.ssr_rdb_forward_bf16)
            err = fn(buf.data_ptr(), *weights, packed.bias.data_ptr(), out.data_ptr(),
                     b, h, w, nf, g, route.tw, stream)
    if err:
        raise RuntimeError(f"rdb kernel launch failed: {_error(err)}")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route_key(x.dtype, route)] += 1
    return (out, buf) if keep_concat else out


# The op satlas_sr_torch::rdb, registered through torch.library's Library
# (define + one impl per device) rather than torch.library.custom_op, whose
# Python wrapper sits between the dispatcher and the function on every call:
# the trunk calls the op 69 times a forward, and at batch 1 the host's launch
# time is what a call costs.
_LIB = torch.library.Library("satlas_sr_torch", "DEF")
_LIB.define("rdb(Tensor x, Tensor[] weights, Tensor bias, int nf, int g) -> Tensor")


def _rdb_op_cuda(x, weights, bias, nf, g):
    return _launch(x, PackedRDB(list(weights), bias), nf, g)


def _rdb_op_cpu(x, weights, bias, nf, g):
    return rdb_reference(x, weights, bias.split([g] * 4 + [nf]), nf, g)


_LIB.impl("rdb", _rdb_op_cuda, "CUDA")
_LIB.impl("rdb", _rdb_op_cpu, "CPU")


@torch.library.register_fake("satlas_sr_torch::rdb")
def _rdb_op_fake(x, weights, bias, nf, g):
    return torch.empty_like(x)


#: The RDB forward as a PyTorch op, so that torch.export keeps it whole. On
#: CUDA: the kernel (`_launch`, counted in LAUNCHES) from packed weights
#: (`pack_weights`: `weights` and the f32 `bias`). On the CPU: `rdb_reference`
#: from the OIHW kernels, `bias` being conv1..conv5's biases concatenated.
#: No autograd formula: `rdb` takes RDBFunction when autograd records.
rdb_op = torch.ops.satlas_sr_torch.rdb.default


class RDBFunction(torch.autograd.Function):
    """One RDB under autograd: the kernel's forward (the plain one on the
    CPU), keeping the concat buffer, and `rdb_backward` from it."""

    @staticmethod
    def forward(ctx, x, packed, nf, g, *params):
        kernels, biases = params[0::2], params[1::2]
        if x.is_cuda:
            out, buf = _launch(x, packed, nf, g, keep_concat=True)
        else:
            out, buf = rdb_reference_with_concat(x, kernels, biases, nf, g)
        ctx.save_for_backward(buf, *kernels)
        ctx.nf, ctx.g = nf, g
        ctx.bias_dtypes = [b.dtype for b in biases]
        return out

    @staticmethod
    def backward(ctx, g_out):
        global BACKWARDS
        BACKWARDS += 1
        buf, *kernels = ctx.saved_tensors
        dx, dws, dbs = rdb_backward(buf, g_out.contiguous(), kernels, ctx.nf, ctx.g)
        grads = [t for dw, db, dt in zip(dws, dbs, ctx.bias_dtypes) for t in (dw, db.to(dt))]
        return (dx, None, None, None, *grads)


def rdb(x: torch.Tensor, kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
        nf: int, g: int, packed: Optional[PackedRDB] = None) -> torch.Tensor:
    """One ResidualDenseBlock, x [B, H, W, nf] NHWC -> [B, H, W, nf].

    On a CPU tensor: the plain version, from `kernels` and `biases`. On a
    CUDA tensor: the kernel, from `packed` (pack_weights of those weights in
    x's dtype, which the caller keeps); raises on what the kernel does not
    take. When autograd records (grad enabled and x or a weight requiring
    it), `RDBFunction` on either device.
    """
    params = [t for kb in zip(kernels, biases) for t in kb]
    train = torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params))
    if x.device.type == "cpu":
        if train:
            return RDBFunction.apply(x, None, nf, g, *params)
        return rdb_op(x, list(kernels), torch.cat([b.reshape(-1) for b in biases]), nf, g)
    if x.device.type != "cuda":
        raise ValueError(f"rdb runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"rdb kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != nf:
        raise ValueError(f"rdb expects [B, H, W, {nf}], got {tuple(x.shape)}")
    if packed is None:
        raise ValueError("the rdb kernel needs packed weights: pass pack_weights(...)")
    if train:
        return RDBFunction.apply(x, packed, nf, g, *params)
    return rdb_op(x, packed.weights, packed.bias, nf, g)

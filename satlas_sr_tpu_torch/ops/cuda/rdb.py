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

Design: five launches over a channels-last dense-concat buffer
[B, H, W, nf + 4g]; launch k reads channels [0, nf + k*g) and writes its
own (see the head of csrc/rdb.cu). Each conv is an implicit GEMM on the
tensor cores (wgmma, f32 accumulation), fed by TMA band loads and bulk
weight copies through a 3-stage ring, one producer warp and two consumer
warpgroups. nf and g must be 32 or 64 (the wgmma widths, WGMMA_N).
- bfloat16: wgmma k16 with both operands read from shared memory; weights
  packed to [cin/16, 9, 2, cout, 8], the image the B descriptor reads.
- float32: three TF32 products per f32 product (hi*hi + lo*hi + hi*lo,
  where hi = tf32(v), lo = tf32(v - hi)), which keeps f32 accuracy where
  one TF32 product would not. Weights are split on the host
  (`round_tf32`) and packed to [cin/8, 9, 2, 2*cout, 4], hi and lo stacked
  along N; the band is split in registers and fed as wgmma's A operand.
Each block streams its conv's whole weight slab (479 KB a call over all
five in bf16, 1.92 MB in f32 with hi and lo) and every launch re-reads the
concat from L2. In f32 those loads hide behind the math: the main loop
(B read from shared memory by every wgmma) and each launch's fixed costs
bound it. The next step runs the five convs in one launch, an image's
concat kept on chip (a 4-block cluster with distributed shared memory)
and the weights multicast.
Weights are packed once per module and dtype (`pack_weights`).

`rdb` takes the plain version (`rdb_reference`) only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises. `LAUNCHES` counts
its kernel calls (one per RDB, five launches each, either dtype), training
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
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

#: input channels per pipeline stage, one 32-byte wgmma k-step (k16 in
#: bf16, k8 in tf32), and the output widths (wgmma N) the kernel is built for
KC = {torch.bfloat16: 16, torch.float32: 8}
WGMMA_N = (32, 64)

#: kernel calls (one per RDB) since the last reset; the plain version does
#: not count
LAUNCHES = 0
#: RDBFunction backwards (`rdb_backward` calls) since the last reset
BACKWARDS = 0

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


class PackedRDB(NamedTuple):
    """Weights of one RDB in the kernel's layout."""

    weights: List[torch.Tensor]  # conv k, in x's dtype: see packed_shape
    bias: torch.Tensor           # [4g + nf] float32, conv1..conv5 concatenated


def rdb_reference(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor], nf: int, g: int) -> torch.Tensor:
    """Plain PyTorch RDB: x [B, H, W, nf] NHWC -> [B, H, W, nf].

    kernels[k] is conv k's OIHW weight [g or nf, nf + k*g, 3, 3] and biases[k]
    its bias; both are cast to x's dtype, as the JAX block casts them.
    """
    if x.shape[-1] != nf:
        raise ValueError(f"x has {x.shape[-1]} channels, expected nf={nf}")
    h = x.permute(0, 3, 1, 2)
    feats = [h]
    for k in range(5):
        y = F.conv2d(torch.cat(feats, dim=1), kernels[k].to(x.dtype),
                     biases[k].to(x.dtype), padding=1)
        if k < 4:
            feats.append(F.leaky_relu(y, 0.2))
    return (y * 0.2 + h).permute(0, 2, 3, 1).contiguous()


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
    for k in range(5):
        cin = nf + k * g
        y = F.conv2d(cat[:, :cin], kernels[k].to(x.dtype), biases[k].to(x.dtype), padding=1)
        if k < 4:
            cat[:, cin:cin + g] = F.leaky_relu(y, 0.2)
    out = (y * 0.2 + x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
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
    cat = buf.permute(0, 3, 1, 2)
    gout = g_out.permute(0, 3, 1, 2)
    g_cat = torch.zeros(buf.shape, dtype=torch.float32, device=buf.device).permute(0, 3, 1, 2)
    g_cat[:, :nf] = gout  # the residual
    g_z = (gout.float() * 0.2).to(dt)  # gradient of conv5's output
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
            slope = torch.where(cat[:, lo:lo + g] > 0, 1.0, 0.2)
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


def _launch(x: torch.Tensor, packed: PackedRDB, nf: int, g: int, keep_concat: bool = False):
    """One kernel call: the output, and with keep_concat the concat buffer
    too, as (out, buf)."""
    global LAUNCHES
    from .build import load

    b, h, w, _ = x.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit of 65535")
    if not x.is_contiguous():
        raise ValueError("rdb kernel needs a contiguous NHWC tensor")
    tensors = [*packed.weights, packed.bias]
    if any(t.device != x.device for t in tensors) or any(t.dtype != x.dtype for t in packed.weights):
        raise ValueError("packed weights must be on x's device and in x's dtype")
    if packed.bias.dtype != torch.float32:
        raise ValueError("packed bias must be float32")
    if [tuple(t.shape) for t in packed.weights] != [packed_shape(k, nf, g, x.dtype)
                                                     for k in range(5)]:
        raise ValueError(f"packed weights do not fit nf={nf}, g={g} in {x.dtype}: "
                         "pack_weights(..., nf, g, x.dtype)")
    lib = load("rdb")
    fn = getattr(lib, f"ssr_rdb_forward_{_KERNEL_DTYPES[x.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ssr_cuda_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(x.device):
        buf = torch.empty((b, h, w, nf + 4 * g), dtype=x.dtype, device=x.device)
        buf[..., :nf].copy_(x)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(buf.data_ptr(), *[t.data_ptr() for t in packed.weights],
                 packed.bias.data_ptr(), out.data_ptr(), b, h, w, nf, g, stream)
    if err:
        raise RuntimeError(f"rdb kernel launch failed: {lib.ssr_cuda_error_string(err).decode()}")
    LAUNCHES += 1
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

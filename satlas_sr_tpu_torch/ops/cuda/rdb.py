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
its kernel calls (one per RDB, five launches each, either dtype). The
kernel is forward-only: there is no backward kernel yet.
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


def _launch(x: torch.Tensor, packed: PackedRDB, nf: int, g: int) -> torch.Tensor:
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
    return out


def rdb(x: torch.Tensor, kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
        nf: int, g: int, packed: Optional[PackedRDB] = None) -> torch.Tensor:
    """One ResidualDenseBlock, x [B, H, W, nf] NHWC -> [B, H, W, nf].

    On a CPU tensor: the plain version, from `kernels` and `biases`. On a
    CUDA tensor: the kernel, from `packed` (pack_weights of those weights in
    x's dtype, which the caller keeps); raises on what the kernel does not
    take. Forward only.
    """
    if x.device.type == "cpu":
        return rdb_reference(x, kernels, biases, nf, g)
    if x.device.type != "cuda":
        raise ValueError(f"rdb runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"rdb kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != nf:
        raise ValueError(f"rdb expects [B, H, W, {nf}], got {tuple(x.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or any(k.requires_grad for k in kernels)):
        raise RuntimeError("the rdb kernel is forward-only: call it under torch.no_grad() "
                           "or torch.inference_mode()")
    if packed is None:
        raise ValueError("the rdb kernel needs packed weights: pass pack_weights(...)")
    return _launch(x, packed, nf, g)

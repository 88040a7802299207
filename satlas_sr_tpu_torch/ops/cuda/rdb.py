"""ResidualDenseBlock as a hand-written CUDA kernel (csrc/rdb.cu).

Replaces `satlas_sr_tpu/ops/pallas/rdb.py:129 rdb_pallas`, which runs one
whole RDB, x + 0.2 * x5 with x_{k+1} = lrelu_0.2(conv3x3_k(concat(x,
x_1 .. x_k))), over NHWC tensors. The port computes the same function; it
does not carry over the TPU kernel's VMEM tiling: the RDB of one 32x32 image
(32*32*192*2 B = 393 KB in bf16) does not fit in the 227 KB of shared memory
a Hopper block can have.

What bounds it on an H100: at esrgan_8S2 width (nf=64, g=32) and B=64 one
call does 2*B*32*32*9*26624 = 31.4 GFLOP and must move 16.8 MB (x in, out
out, bf16), so it is compute-bound: about 32 us at the 989 TFLOP/s bf16
tensor-core peak, 0.47 ms at the 67 TFLOP/s float32 CUDA-core peak.

Design: five launches over a channels-last dense-concat buffer
[B, H, W, nf + 4g]; launch k reads channels [0, nf + k*g) and writes its
own (see the head of csrc/rdb.cu).
- bfloat16: an implicit GEMM per conv on the tensor cores (wgmma, f32
  accumulation), fed by TMA band loads and bulk weight copies through a
  3-stage ring, one producer warp and two consumer warpgroups. Weights are
  packed to [cin/16, 9, 2, cout, 8], the shared-memory image the wgmma
  descriptor reads, 16 input channels per stage. Each block still streams
  its conv's whole weight slab (479 KB a call over all five) and re-reads
  the concat from L2 in every launch; the next step keeps an image's concat
  on chip across the five convs (a 4-block cluster with distributed shared
  memory) and multicasts the weights.
- float32: a direct conv on CUDA cores, plain FMAs (no TF32), weights
  packed to [cout/32, cin, 9, 32].
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

#: float32 kernel: output-channel tile (CO in csrc/rdb.cu); nf and g must be
#: multiples of it
CO_TILE = 32
#: bfloat16 kernel: input channels per pipeline stage, one wgmma k16 (KC in
#: csrc/rdb.cu), and the output widths (wgmma N) it is built for
KC = 16
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


def packed_shape(k: int, nf: int, g: int, dtype: torch.dtype) -> tuple:
    """Shape of conv k's packed weight for the kernel of `dtype`.

    bfloat16: [cin/16, 9, 2, cout, 8], element [j, t, h, n, e] = W[n, 16j +
    8h + e, t // 3, t % 3]: per 16 input channels (one pipeline stage) and
    tap, two K-major 8 x 8 core-matrix columns of wgmma's B operand.
    float32: [cout/32, cin, 9, 32], element [c, i, t, o] = W[32c + o, i, t // 3,
    t % 3].
    """
    cout, cin = (g if k < 4 else nf), nf + k * g
    if dtype == torch.bfloat16:
        return (cin // KC, 9, 2, cout, 8)
    return (cout // CO_TILE, cin, 9, CO_TILE)


def pack_weights(kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 nf: int, g: int, dtype: torch.dtype) -> PackedRDB:
    """OIHW conv weights -> the `dtype` kernel's layout (`packed_shape`);
    biases -> f32."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the rdb kernel takes float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and (nf not in WGMMA_N or g not in WGMMA_N):
        raise ValueError(f"the bfloat16 rdb kernel needs nf and g in {WGMMA_N}, "
                         f"got nf={nf}, g={g}")
    if nf % CO_TILE or g % CO_TILE:
        raise ValueError(f"the rdb kernel needs nf and g divisible by {CO_TILE}, "
                         f"got nf={nf}, g={g}")
    ws = []
    for k, w in enumerate(kernels):
        cout, cin = (g if k < 4 else nf), nf + k * g
        if tuple(w.shape) != (cout, cin, 3, 3):
            raise ValueError(f"conv{k + 1} weight {tuple(w.shape)}, expected {(cout, cin, 3, 3)}")
        w = w.detach().reshape(cout, cin, 9)
        if dtype == torch.bfloat16:
            w = w.reshape(cout, cin // KC, 2, 8, 9).permute(1, 4, 2, 0, 3)
        else:
            w = w.reshape(cout // CO_TILE, CO_TILE, cin, 9).permute(0, 2, 3, 1)
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

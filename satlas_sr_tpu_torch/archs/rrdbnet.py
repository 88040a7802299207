"""Multi-frame ESRGAN generator (SSR_RRDBNet) in PyTorch.

Counterpart of satlas_sr_tpu/archs/rrdbnet.py: a time series of Sentinel-2
frames is channel-stacked into the first conv, runs through num_block
Residual-in-Residual Dense Blocks and is upsampled x4 (x8/x16 add stages;
x1/x2 fold space into channels with pixel_unshuffle first).

- `forward` takes and returns NHWC, like the JAX model.
- Module and parameter names are those of the reference .pth
  (conv_first, body.{i}.rdb{1..3}.conv{1..5}, conv_body, conv_up1..4,
  conv_hr, conv_last), so a released `params_ema` state dict loads with
  load_state_dict.
- The trunk calls the `rdb` op: the CUDA kernel on the card, the plain
  version on the CPU; under autograd its Function (kernel forward, cuDNN
  backward from the saved concat). The heads use F.conv2d through
  channels-last views, casting float32 master weights to x's dtype.
- `freeze_rdbs` gives the form torch.export traces: each RDB's weights
  packed once into buffers (`FrozenRDB`), no per-call repack.
- `forward_band(x_band, space)` is the forward of one row band of the
  image on a rank of a space group (parallel/mesh.mesh_2d), sharing the
  modules of `forward`, which stays as it is (export traces it, the
  trainers call it). Each head conv takes one halo row a side
  (parallel/halo.exchange_rows) and each RDB five, one a conv of the
  kernel's five: conv k is wrong only on the k outermost halo rows, so
  the band's own rows are exact. A side that is the image's border takes
  no rows, and the conv's (the kernel's) own zero padding applies there as
  in the whole image; a missing side is never padded with zero rows, on
  which the kernel would compute x1..x4 = lrelu(bias + ...) != 0.
  pixel_unshuffle, the nearest upsampling, lrelu and the residual adds
  are per pixel (band rows must divide by the unshuffle factor). One
  exchange a launch: 69 a forward, none fused across an RRDB.
- `remat` (network_g.remat; the JAX modes, archs/rrdbnet.py:194-233) is
  activation checkpointing of the trunk under autograd, with
  torch.utils.checkpoint (non-reentrant): False/None none; True/'block'
  around each RRDB (its input kept, its three RDBs rerun in the backward);
  'rdb' around each RDB (three inputs a block kept, one RDB rerun at a
  time). A rerun RDB launches the kernel again, and its concat buffer
  (which RDBFunction keeps for the backward) lives only from the rerun to
  its backward. `forward_band` reruns the same way, its halo exchanges
  included. 'conv_outs' asks XLA to keep the conv outputs and rerun
  only the lrelu/concat chains; RDBFunction already keeps just that (the
  concat of x and the lrelu'd conv outputs) and reruns no convolution, so
  the port runs it as False. The numbers are those of no remat.
- Parameters are made on the CPU from an explicit torch.Generator seeded by
  `seed` (kaiming-normal x0.1 for the dense-block convs, as the reference
  and the JAX init do; variance 1/fan_in for the heads; zero biases), then
  moved to `device`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.cuda.rdb import pack_weights, rdb, rdb_op
from ..ops.pixelshuffle import pixel_unshuffle
from ..ops.resize import upsample_nearest
from ..parallel.halo import exchange_rows


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """3x3 'same' conv of an NHWC tensor, through a channels-last NCHW view.
    Weight and bias are cast to x's dtype (float32 master weights, compute
    in the trainer's compute dtype), as the JAX convs cast them."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def _conv_band(conv: nn.Module, x: torch.Tensor, space) -> torch.Tensor:
    """`_conv_nhwc` on a row band: one halo row from each neighbour band,
    the conv's zero padding on the image's borders, the band's rows kept."""
    ext, top, _ = exchange_rows(x, 1, space)
    return _conv_nhwc(conv, ext)[:, top:top + x.shape[1]]


def _rdb_band(rdb_module: nn.Module, x: torch.Tensor, space) -> torch.Tensor:
    """One RDB (the `rdb` op) on a row band: five halo rows from each
    neighbour band, the band's rows of the result kept."""
    ext, top, _ = exchange_rows(x, 5, space)
    return rdb_module(ext)[:, top:top + x.shape[1]].contiguous()


class ResidualDenseBlock(nn.Module):
    """5-conv dense block with a 0.2-scaled residual, run by the `rdb` op."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.num_feat, self.num_grow_ch = num_feat, num_grow_ch
        nf, g = num_feat, num_grow_ch
        for k in range(5):
            setattr(self, f"conv{k + 1}",
                    nn.Conv2d(nf + k * g, g if k < 4 else nf, 3, padding=1, device="meta"))
        self._packed = None
        self._packed_key = None

    def convs(self):
        return [getattr(self, f"conv{k + 1}") for k in range(5)]

    def _packed_for(self, x: torch.Tensor):
        """Kernel-layout weights, packed once per dtype and per weight version
        (an in-place load_state_dict or a move repacks). An optimizer that
        updates in place without bumping `_version` (fused Adam) must be
        followed by `RRDBNet.invalidate_packs`, as the trainer does."""
        params = [p for c in self.convs() for p in (c.weight, c.bias)]
        key = (x.dtype, x.device, tuple((p.data_ptr(), p._version) for p in params))
        if key != self._packed_key:
            convs = self.convs()
            self._packed = pack_weights([c.weight for c in convs], [c.bias for c in convs],
                                        self.num_feat, self.num_grow_ch, x.dtype)
            self._packed_key = key
        return self._packed

    def invalidate_pack(self) -> None:
        self._packed_key = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = self.convs()
        packed = self._packed_for(x) if x.is_cuda else None
        return rdb(x.contiguous(), [c.weight for c in convs], [c.bias for c in convs],
                   self.num_feat, self.num_grow_ch, packed=packed)

    def frozen(self) -> "FrozenRDB":
        """This block's weights, fixed, in the form the `rdb` op takes on the
        weights' device and in their dtype (see FrozenRDB)."""
        convs = self.convs()
        kernels = [c.weight.detach() for c in convs]
        biases = [c.bias.detach() for c in convs]
        if kernels[0].is_cuda:
            packed = pack_weights(kernels, biases, self.num_feat, self.num_grow_ch,
                                  kernels[0].dtype)
            weights, bias = packed.weights, packed.bias
        else:
            weights, bias = kernels, torch.cat([b.reshape(-1) for b in biases])
        return FrozenRDB(weights, bias, self.num_feat, self.num_grow_ch)


class FrozenRDB(nn.Module):
    """A ResidualDenseBlock that torch.export can trace: its weights packed
    once, held as buffers, and handed to the `rdb` op (`rdb_op`) as tensors.
    The forward reads no data_ptr or _version and packs nothing. On CUDA the
    buffers are the kernel's layout (`pack_weights`), on the CPU the OIHW
    kernels and the concatenated biases, so an exported program runs on the
    device and in the dtype it was frozen for."""

    def __init__(self, weights, bias: torch.Tensor, num_feat: int, num_grow_ch: int):
        super().__init__()
        self.num_feat, self.num_grow_ch = num_feat, num_grow_ch
        for k, w in enumerate(weights):
            self.register_buffer(f"w{k + 1}", w)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = [getattr(self, f"w{k + 1}") for k in range(5)]
        return rdb_op(x.contiguous(), weights, self.bias, self.num_feat, self.num_grow_ch)


def freeze_rdbs(model: nn.Module, device=None) -> nn.Module:
    """A copy of `model` on `device` (default: where it is) with every
    ResidualDenseBlock replaced by its FrozenRDB, packed for that device and
    the model's dtype, and no parameter requiring grad: the form the
    exporter traces. Models without RDBs (SRCNN, HighResNet) are copied."""
    import copy

    frozen = copy.deepcopy(model).requires_grad_(False)
    if device is not None:
        frozen = frozen.to(device)
    for parent in list(frozen.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, ResidualDenseBlock):
                setattr(parent, name, child.frozen())
    return frozen


def check_remat(mode):
    """`mode` if it is one of the JAX package's remat modes, else its ValueError."""
    if not (mode is None or isinstance(mode, bool) or mode in ("block", "rdb", "conv_outs")):
        raise ValueError(f"remat must be False/True/'block'/'rdb'/'conv_outs', got {mode!r}")
    return mode


def _rerun(module, x: torch.Tensor) -> torch.Tensor:
    """module(x), rerun in the backward instead of keeping its activations
    (no RNG state kept: the trunk draws no random numbers). On a row band
    the rerun repeats the block's halo exchanges: every rank of the space
    group reruns the same blocks in the same order of its backward."""
    return checkpoint(module, x, use_reentrant=False, preserve_rng_state=False)


class RRDB(nn.Module):
    """Residual-in-Residual Dense Block: 3 RDBs + 0.2-scaled outer residual."""

    def __init__(self, num_feat: int, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)
        #: rerun each RDB in the backward (remat 'rdb')
        self.remat_rdb = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for rdb in (self.rdb1, self.rdb2, self.rdb3):
            out = _rerun(rdb, out) if self.remat_rdb and torch.is_grad_enabled() else rdb(out)
        return out * 0.2 + x

    def forward_band(self, x: torch.Tensor, space) -> torch.Tensor:
        out = x
        rerun = self.remat_rdb and torch.is_grad_enabled()
        for rdb in (self.rdb1, self.rdb2, self.rdb3):
            band = lambda t, rdb=rdb: _rdb_band(rdb, t, space)
            out = _rerun(band, out) if rerun else band(out)
        return out * 0.2 + x


class RRDBNet(nn.Module):
    """ESRGAN generator over channel-stacked multi-frame input.

    Input:  [B, 32, 32, num_in_ch] NHWC (num_in_ch = n_frames * 3 for TCI input)
    Output: [B, 32*scale, 32*scale, num_out_ch]
    """

    def __init__(self, num_in_ch: int, num_out_ch: int, scale: int = 4,
                 num_feat: int = 64, num_block: int = 23, num_grow_ch: int = 32,
                 dtype: torch.dtype = torch.float32, seed: int = 0, device="cuda",
                 remat=False):
        super().__init__()
        if scale not in (1, 2, 4, 8, 16):
            raise ValueError(f"scale must be 1, 2, 4, 8 or 16, got {scale}")
        device = resolve_device(device)
        self.scale = scale
        #: the trunk's rerun mode (see the module docstring)
        self.remat = check_remat(remat)
        #: compute dtype the inference engine runs the model in
        self.dtype = dtype
        in_ch = num_in_ch * {1: 16, 2: 4}.get(scale, 1)
        conv = lambda cin, cout: nn.Conv2d(cin, cout, 3, padding=1, device="meta")
        self.conv_first = conv(in_ch, num_feat)
        self.body = nn.ModuleList(RRDB(num_feat, num_grow_ch) for _ in range(num_block))
        for block in self.body:
            block.remat_rdb = remat == "rdb"
        self.conv_body = conv(num_feat, num_feat)
        self.conv_up1 = conv(num_feat, num_feat)
        self.conv_up2 = conv(num_feat, num_feat)
        if scale in (8, 16):
            self.conv_up3 = conv(num_feat, num_feat)
        if scale == 16:
            self.conv_up4 = conv(num_feat, num_feat)
        self.conv_hr = conv(num_feat, num_feat)
        self.conv_last = conv(num_feat, num_out_ch)
        self.to_empty(device="cpu")
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        dense = {id(c) for m in self.modules() if isinstance(m, ResidualDenseBlock)
                 for c in m.convs()}
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * 9
                std = 0.1 * math.sqrt(2.0 / fan_in) if id(m) in dense else math.sqrt(1.0 / fan_in)
                m.weight.normal_(0.0, std, generator=gen)
                m.bias.zero_()

    def invalidate_packs(self) -> None:
        """Repack every RDB's kernel weights at its next forward: call after
        an optimizer step."""
        for m in self.modules():
            if isinstance(m, ResidualDenseBlock):
                m.invalidate_pack()

    @property
    def band_rows(self):
        """(factor, least): the input rows of a band must divide by `factor`
        (pixel_unshuffle's) and number at least `least` (the RDB halo)."""
        factor = {1: 4, 2: 2}.get(self.scale, 1)
        return factor, 5 * factor

    def _ups(self):
        ups = [self.conv_up1, self.conv_up2]
        if self.scale in (8, 16):
            ups.append(self.conv_up3)
        if self.scale == 16:
            ups.append(self.conv_up4)
        return ups

    def forward_band(self, x: torch.Tensor, space) -> torch.Tensor:
        """`forward` of this rank's row band x [B, h, W, C] of an image split
        over `space` (a mesh.SpaceLayout): [B, h*scale, W*scale, C_out], the
        same rows of the whole image's output (see the module docstring)."""
        factor = self.band_rows[0]
        if factor > 1:
            x = pixel_unshuffle(x, factor)
        feat = _conv_band(self.conv_first, x, space)
        body = feat
        rerun = (self.remat is True or self.remat == "block") and torch.is_grad_enabled()
        for block in self.body:
            band = lambda t, block=block: block.forward_band(t, space)
            body = _rerun(band, body) if rerun else band(body)
        feat = feat + _conv_band(self.conv_body, body, space)
        for up in self._ups():
            feat = lrelu(_conv_band(up, upsample_nearest(feat, 2), space))
        return _conv_band(self.conv_last, lrelu(_conv_band(self.conv_hr, feat, space)), space)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = _conv_nhwc(self.conv_first, x)
        body = feat
        rerun_blocks = (self.remat is True or self.remat == "block") and torch.is_grad_enabled()
        for block in self.body:
            body = _rerun(block, body) if rerun_blocks else block(body)
        feat = feat + _conv_nhwc(self.conv_body, body)
        ups = [self.conv_up1, self.conv_up2]
        if self.scale in (8, 16):
            ups.append(self.conv_up3)
        if self.scale == 16:
            ups.append(self.conv_up4)
        for up in ups:
            feat = lrelu(_conv_nhwc(up, upsample_nearest(feat, 2)))
        return _conv_nhwc(self.conv_last, lrelu(_conv_nhwc(self.conv_hr, feat)))

"""Building blocks of SRCNN and HighResNet, in PyTorch (NCHW inside).

Counterpart of satlas_sr_tpu/archs/blocks.py (reflect_conv .. PixelShuffleBlock).
Module and parameter names are those of the reference .pth files, whose
nn.Sequential index layout they keep: in a DoubleConv2d the convs sit at 0
and 4 and the PReLUs at 2 and 6 (1 and 5 are parameter-free slots, 3 and 7
Dropout(0.5), inert in eval); in a PixelShuffleBlock the shuffle is 0, the
convs 1 and 4, the PReLUs 3 and 6; in a FusionBlock the residual block is 0,
the projection 1 and the PReLU 3.

The blocks the registered archs do not use (the reference carries them
over from BasicSR and WorldStrat) follow: DenseBlock (a ResidualBlock's
DoubleConv2d with a concat skip, so its names are the ResidualBlock's),
ConvTransposeBlock (ConvTranspose2d with stride = zoom, then two reflect
convs, PReLUs after each: `upsample` slots 0-1, then the PixelShuffleBlock
layout, convs at 2 and 5, PReLUs at 4 and 7), ResidualBlockNoBN (conv1,
conv2), Upsample (an nn.Sequential of conv + PixelShuffle stages, convs at
the even slots), `trunc_normal_init` and DCNv2Pack (`weight`, `bias`,
`conv_offset`: BasicSR's ModulatedDeformConvPack names), the last on
ops/warp.deform_conv2d. No released checkpoint holds these, so their names
follow BasicSR's where it has the block and the layout above where not.

Convs and PReLUs compute in their input's dtype, casting their float32
weights, so a training network keeps float32 weights under a bfloat16
compute dtype (the JAX blocks' `dtype`). Dropout is active in train mode
and draws its keep masks from the network's `DropoutMasks`: a seeded
torch.Generator of its own, or masks handed in to replay (the tests replay
the JAX step's, which flax draws from the step's `dropout` key).

RecursiveFusion zero-pads the revisits to a power of two and applies ONE
FusionBlock at every level (the reference shares its weights across levels),
so its state dict holds the names of level 0 only (fusion.0.*).

Row bands (the 'space' sharding of inference, parallel/mesh.mesh_2d):
`band_call(module, x, space)` runs a block on one rank's row band of an
NCHW image. `reflect_conv_band` takes its halo rows from the neighbour
bands (parallel/halo.pad_rows) and, on the image's top or bottom
border, reflects the band's own rows, which there are the image's, so it
equals reflecting the whole image; W is reflected as before. The rest is
per pixel and needs no halo: PReLU, eval-mode Dropout, the revisit
pairing of FusionBlock, PixelShuffle (a band of h rows becomes h x zoom),
and train-mode Dropout, whose masks are drawn for the whole image and
sliced to the band (DropoutMasks). Under autograd the halo exchanges are
differentiable, so the band forwards train as they are.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Iterable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.halo import pad_rows, reflect_pad


def reflect_conv(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """'same' conv of NCHW x with reflect padding (torch padding_mode='reflect';
    an even kernel pads one more on the bottom and right)."""
    kh, kw = weight.shape[-2:]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x = reflect_pad(reflect_pad(x, ph, kh - 1 - ph, 2), pw, kw - 1 - pw, 3)
    return F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def reflect_conv_band(x: torch.Tensor, weight: torch.Tensor, bias, space) -> torch.Tensor:
    """`reflect_conv` of this rank's row band of an NCHW image split over
    `space`: halo rows from the neighbour bands, the band's own rows
    reflected on the image's borders."""
    kh, kw = weight.shape[-2:]
    ph = (kh - 1) // 2
    pw = (kw - 1) // 2
    x = pad_rows(x, ph, kh - 1 - ph, space, dim=2, border="reflect")
    x = reflect_pad(x, pw, kw - 1 - pw, 3)
    return F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def band_call(module: nn.Module, x: torch.Tensor, space) -> torch.Tensor:
    """module(x) on a row band: an nn.Sequential layer by layer, a block by
    its `forward_band`, a per-pixel module as it is. A conv wider than one
    row without a band forward raises (it would read zeros at the band's
    edges)."""
    if isinstance(module, nn.Sequential):
        for m in module:
            x = band_call(m, x, space)
        return x
    forward_band = getattr(module, "forward_band", None)
    if forward_band is not None:
        return forward_band(x, space)
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)) and module.kernel_size[0] > 1:
        raise ValueError(f"{type(module).__name__} {module.kernel_size} has no row-band forward")
    return module(x)


class DropoutMasks:
    """Where one network's dropout layers take their keep masks, in call order.

    By default each mask is drawn from `generator` (seeded; its state rides
    the training state, so a resume replays the draws). `replay(masks)`
    queues given boolean masks instead, which the next calls consume in
    order; with `record` set to a list every mask used is appended to it.
    As rank `rank` of `world` data-parallel processes each mask (drawn,
    replayed, recorded) is the global batch's, world x the local rows, and
    the rank keeps its rows [rank b, (rank + 1) b). On a row-band layout
    `rank` and `world` are the data group's and the mask is also the whole
    image's, `bands` x the band's rows (NCHW: dim 2), of which the rank
    keeps band `band`."""

    def __init__(self, seed: int = 0, device="cpu", rank: int = 0, world: int = 1,
                 band: int = 0, bands: int = 1):
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.rank, self.world = rank, world
        self.band, self.bands = band, bands
        self.queue: deque = deque()
        self.record: Optional[List[torch.Tensor]] = None

    def replay(self, masks: Iterable[torch.Tensor]) -> None:
        self.queue.extend(masks)

    def keep(self, shape: torch.Size, keep_prob: float, device) -> torch.Tensor:
        b, h = shape[0], shape[2]
        shape = (b * self.world, shape[1], h * self.bands) + tuple(shape[3:])
        if self.queue:
            mask = self.queue.popleft()
            if tuple(mask.shape) != tuple(shape):
                raise ValueError(f"replayed dropout mask {tuple(mask.shape)} != {tuple(shape)}")
            mask = mask.to(device=device, dtype=torch.bool)
        else:
            mask = torch.rand(shape, generator=self.generator, device=device) < keep_prob
        if self.record is not None:
            self.record.append(mask.cpu())
        if self.bands > 1:
            mask = mask[:, :, self.band * h:(self.band + 1) * h]
        return mask[self.rank * b:(self.rank + 1) * b] if self.world > 1 else mask


class Dropout(nn.Module):
    """Dropout whose keep mask comes from `masks` (a DropoutMasks, set by the
    network); kept values are scaled by 1 / keep_prob, as flax and torch do."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.masks: Optional[DropoutMasks] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.masks is None:
            raise RuntimeError("Dropout in train mode needs the network's DropoutMasks "
                               "(set_dropout_masks)")
        keep_prob = 1.0 - self.p
        keep = self.masks.keep(x.shape, keep_prob, x.device)
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class PReLU(nn.PReLU):
    """One-parameter PReLU computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class ReflectConv(nn.Conv2d):
    """nn.Conv2d (stride 1) with reflect 'same' padding."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, bias: bool = True):
        super().__init__(cin, cout, kernel_size, bias=bias, device="meta")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_conv(x, self.weight, self.bias)

    def forward_band(self, x: torch.Tensor, space) -> torch.Tensor:
        return reflect_conv_band(x, self.weight, self.bias, space)


class DoubleConv2d(nn.Module):
    """Two reflect convs, each followed by a one-parameter PReLU and Dropout(0.5)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.doubleconv2d = nn.Sequential(
            ReflectConv(cin, cout, kernel_size), nn.Identity(), PReLU(device="meta"), Dropout(0.5),
            ReflectConv(cout, cout, kernel_size), nn.Identity(), PReLU(device="meta"), Dropout(0.5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.doubleconv2d(x)

    def forward_band(self, x: torch.Tensor, space) -> torch.Tensor:
        return band_call(self.doubleconv2d, x, space)


class ResidualBlock(nn.Module):
    """DoubleConv2d with an additive skip."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        self.residualblock = DoubleConv2d(channels, channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.residualblock(x)

    def forward_band(self, x: torch.Tensor, space) -> torch.Tensor:
        return x + self.residualblock.forward_band(x, space)


class OneHot(nn.Module):
    """Integer mask [N, 1, H, W] -> float one-hot [N, num_classes, H, W]."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.one_hot(x[:, 0].long(), self.num_classes).permute(0, 3, 1, 2).float()


class FusionBlock(nn.Module):
    """Fuses revisit pairs (t, t + T/2): [B, T, C, H, W] -> [B, T/2, C, H, W]."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        self.channels = channels
        self.fuse = nn.Sequential(ResidualBlock(2 * channels, kernel_size),
                                  ReflectConv(2 * channels, channels, kernel_size), nn.Identity(),
                                  PReLU(device="meta"))

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        b, t, c, h, w = x.shape
        half = t // 2
        pair = torch.cat([x[:, :half], x[:, half:]], dim=2).reshape(b * half, 2 * c, h, w)
        fused = self.fuse(pair) if space is None else band_call(self.fuse, pair, space)
        return fused.reshape(b, half, self.channels, h, w)

    def forward_band(self, x: torch.Tensor, space) -> torch.Tensor:
        return self.forward(x, space)


class RecursiveFusion(nn.Module):
    """log2(T) pairwise fusions through one shared FusionBlock: [B, T, C, H, W] -> [B, C, H, W]."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        self.fusion = nn.Sequential(FusionBlock(channels, kernel_size))

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        b, t, c, h, w = x.shape
        pow2 = 1 << (t - 1).bit_length()
        if pow2 != t:  # zero revisits up to the next power of two
            x = torch.cat([x, x.new_zeros(b, pow2 - t, c, h, w)], dim=1)
        while x.shape[1] > 1:
            x = self.fusion[0](x, space)
        return x[:, 0]

    def forward_band(self, x: torch.Tensor, space) -> torch.Tensor:
        return self.forward(x, space)


class PixelShuffleBlock(nn.Module):
    """PixelShuffle(zoom), then two reflect convs with PReLUs."""

    def __init__(self, cin: int, cout: int, sr_kernel_size: int = 1, zoom_factor: int = 4):
        super().__init__()
        shuffled = cin // zoom_factor ** 2
        self.upsample = nn.Sequential(
            nn.PixelShuffle(zoom_factor), ReflectConv(shuffled, shuffled, sr_kernel_size), nn.Identity(),
            PReLU(device="meta"), ReflectConv(shuffled, cout, sr_kernel_size), nn.Identity(),
            PReLU(device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.upsample(x)

    def forward_band(self, x: torch.Tensor, space) -> torch.Tensor:
        return band_call(self.upsample, x, space)


@torch.no_grad()
def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """The JAX init from `gen`: conv weights uniform in +-1/sqrt(fan_in) (torch's
    own Conv2d default), zero biases, PReLU slopes 0.25; a DCNv2Pack's own
    `init_weights` last (its conv_offset at zero)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
    for m in module.modules():
        if isinstance(m, DCNv2Pack):
            m.init_weights(gen)


class DenseBlock(ResidualBlock):
    """DoubleConv2d with a concat skip: [N, C, H, W] -> [N, C + cout, H, W]."""

    def __init__(self, channels: int, kernel_size: int = 3, cout: Optional[int] = None):
        nn.Module.__init__(self)
        self.residualblock = DoubleConv2d(channels, cout or channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, self.residualblock(x)], dim=1)

    def forward_band(self, x: torch.Tensor, space) -> torch.Tensor:
        return torch.cat([x, self.residualblock.forward_band(x, space)], dim=1)


class ConvTransposeBlock(nn.Module):
    """ConvTranspose2d (stride zoom_factor, no padding: (in - 1) * zoom + k
    out), then a reflect conv and an sr_kernel_size reflect conv, a PReLU
    after each of the three."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, sr_kernel_size: int = 3,
                 zoom_factor: int = 4):
        super().__init__()
        self.upsample = nn.Sequential(
            nn.ConvTranspose2d(cin, cin, kernel_size, stride=zoom_factor, device="meta"),
            PReLU(device="meta"), ReflectConv(cin, cin, kernel_size), nn.Identity(),
            PReLU(device="meta"), ReflectConv(cin, cout, sr_kernel_size), nn.Identity(),
            PReLU(device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deconv = self.upsample[0]
        y = F.conv_transpose2d(x, deconv.weight.to(x.dtype), deconv.bias.to(x.dtype),
                               stride=deconv.stride)
        return self.upsample[1:](y)


class ResidualBlockNoBN(nn.Module):
    """x + res_scale * conv2(relu(conv1(x))), 3x3 convs with zero padding."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1, device="meta")
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1, device="meta")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(F.conv2d(x, self.conv1.weight.to(x.dtype), self.conv1.bias.to(x.dtype), padding=1))
        y = F.conv2d(y, self.conv2.weight.to(x.dtype), self.conv2.bias.to(x.dtype), padding=1)
        return x + y * self.res_scale


class Upsample(nn.Sequential):
    """Pixel-shuffle upsampler for scales 2^n (n stages of conv to 4 nf +
    PixelShuffle(2)) and 3 (conv to 9 nf + PixelShuffle(3))."""

    def __init__(self, scale: int, num_feat: int):
        if scale & (scale - 1) == 0:
            stages = [(4, 2)] * (scale.bit_length() - 1)
        elif scale == 3:
            stages = [(9, 3)]
        else:
            raise ValueError(f"scale {scale} not supported (2^n and 3 only)")
        layers = []
        for mult, r in stages:
            layers += [nn.Conv2d(num_feat, mult * num_feat, 3, 1, 1, device="meta"),
                       nn.PixelShuffle(r)]
        super().__init__(*layers)


def trunc_normal_init(std: float = 1.0, mean: float = 0.0, a: float = -2.0, b: float = 2.0):
    """A truncated-normal initializer, `init(shape, generator)`: normal(mean,
    std) truncated to [a, b] (the reference's trunc_normal_), drawn from the
    given torch.Generator."""

    def init(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype)
        return nn.init.trunc_normal_(t, mean=mean, std=std, a=a, b=b, generator=generator)

    return init


class DCNv2Pack(nn.Module):
    """Modulated deformable conv whose offsets and mask come from a conv of
    an auxiliary feature map: conv_offset(feat) -> (o1, o2, mask) thirds,
    offsets = cat(o1, o2) read as (dy, dx) pairs per tap (tap k: channels 2k
    and 2k + 1, as mmcv's kernel reads them), mask = sigmoid. conv_offset
    starts at zero, so a fresh block is a plain conv with mask 0.5."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, deformable_groups: int = 1):
        super().__init__()
        if deformable_groups != 1:
            raise ValueError(f"deformable_groups={deformable_groups}: only 1 is supported")
        k = kernel_size
        self.padding = (k - 1) // 2
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device="meta"))
        self.bias = nn.Parameter(torch.empty(cout, device="meta"))
        self.conv_offset = nn.Conv2d(cin, 3 * k * k, k, 1, self.padding, device="meta")

    def forward(self, x: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        from ..ops.warp import deform_conv2d

        out = F.conv2d(feat, self.conv_offset.weight.to(feat.dtype),
                       self.conv_offset.bias.to(feat.dtype), padding=self.padding)
        o1, o2, mask = out.chunk(3, dim=1)
        return deform_conv2d(x, torch.cat([o1, o2], dim=1), self.weight, self.bias,
                             torch.sigmoid(mask), stride=1, padding=self.padding)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Weight uniform in +-1/sqrt(fan_in), zero bias, zero conv_offset."""
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.uniform_(-bound, bound, generator=gen)
        self.bias.zero_()
        self.conv_offset.weight.zero_()
        self.conv_offset.bias.zero_()

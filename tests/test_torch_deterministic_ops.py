"""The scatter-free forms of the port's train-path ops against the forms they
replace, on the CPU in float32.

On the card the replaced forms' backwards accumulate with atomics (F.pad's
reflect, an index_select's index_add, F.interpolate's bilinear, an
advanced-index gather's index_put), so a train run through them does not
repeat. The new forms (parallel/halo.reflect_pad, ops/resize's
interpolation matrices, ops/crop's tap matrices) must compute the same
function:
- reflect padding: bit-equal forward, input gradients within 1e-6 relative;
- the SSIM filter: bit-equal to the index_select form;
- the bilinear resize: within 1e-6 of F.interpolate, up, down, antialiased
  and not;
- the box crop: within 1e-6 of the gather form, forward and image gradient
  (of its largest entry; the cotangent is positive, so no sum cancels),
  degenerate, edge and out-of-image boxes included.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from satlas_sr_tpu_torch.archs import SRCNN, HighResNet
from satlas_sr_tpu_torch.archs.blocks import DropoutMasks, reflect_conv
from satlas_sr_tpu_torch.ops.crop import crop_resize_boxes
from satlas_sr_tpu_torch.ops.resize import resize_bilinear
from satlas_sr_tpu_torch.ops.ssim import _gaussian_1d, _window_sum, filter_separable_reflect, ssim_loss
from satlas_sr_tpu_torch.parallel.halo import reflect_pad
from torch_threads import two_torch_threads  # noqa: F401


def _rand(*shape, seed=0, grad=False):
    return torch.rand(*shape, generator=torch.Generator().manual_seed(seed)).requires_grad_(grad)


def _grad(y, x, seed=1):
    return torch.autograd.grad(y, x, _rand(*y.shape, seed=seed))[0]


def _rel(got, want):
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_reflect_pad_is_f_pad_reflect(k, dim):
    x = _rand(2, 3, 9, 11, grad=True)
    before, after = (k - 1) // 2, k - 1 - (k - 1) // 2
    pads = (0, 0, before, after) if dim == 2 else (before, after, 0, 0)
    got, want = reflect_pad(x, before, after, dim), F.pad(x, pads, mode="reflect")
    assert torch.equal(got, want)
    assert _rel(_grad(got, x), _grad(want, x)) <= 1e-6


@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5), (2, 2), (1, 3), (3, 1), (1, 1)])
def test_reflect_conv_is_the_f_pad_conv(kh, kw):
    x = _rand(2, 4, 10, 12, grad=True)
    w, b = _rand(5, 4, kh, kw, seed=2) - 0.5, _rand(5, seed=3)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    want = F.conv2d(F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph), mode="reflect"), w, b)
    got = reflect_conv(x, w, b)
    assert torch.equal(got, want)
    assert _rel(_grad(got, x), _grad(want, x)) <= 1e-6


def _reflect_index(n, pad):
    idx = torch.arange(-pad, n + pad).abs()
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


@pytest.mark.parametrize("hw", [(16, 16), (7, 13)])
def test_ssim_filter_is_the_index_select_form(hw):
    h, w = hw
    x = _rand(2, h, w, 3, grad=True)
    k1d = _gaussian_1d(5, 1.5)
    got = filter_separable_reflect(x, k1d)
    # the old form: the same shifted-product sums on the index_select padding
    xr = x.index_select(1, _reflect_index(h, 2)).index_select(2, _reflect_index(w, 2))
    want = _window_sum(_window_sum(xr, k1d, 1, h), k1d, 2, w)
    assert torch.equal(got, want)
    assert torch.equal(_grad(got, x), _grad(want, x))


RESIZES = [((32, 32), (128, 128)), ((32, 32), (8, 8)), ((17, 40), (31, 33)),
           ((32, 32), (13, 77)), ((128, 128), (32, 32)), ((20, 8), (20, 24))]


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_bilinear_is_f_interpolate(src, dst, antialias):
    x = _rand(2, *src, 3, grad=True)
    got = resize_bilinear(x, dst, antialias)
    flag = antialias and (dst[0] < src[0] or dst[1] < src[1])
    want = F.interpolate(x.permute(0, 3, 1, 2), size=dst, mode="bilinear", align_corners=False,
                         antialias=flag).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-6
    assert (_grad(got, x) - _grad(want, x)).abs().max().item() <= 1e-6 * _grad(want, x).abs().max()


def _crop_gather(img, boxes, s):
    """ops/crop.crop_resize_boxes as it was: the four taps gathered by
    advanced indexing (backward: index_put with accumulation)."""
    b, h, w, _ = img.shape
    x1, y1, x2, y2 = (boxes[..., i, None] for i in range(4))
    grid = torch.arange(s, dtype=torch.float32) + 0.5
    ys = grid * ((y2 - y1).float() / s) - 0.5 + y1.float()
    xs = grid * ((x2 - x1).float() / s) - 0.5 + x1.float()
    ys = torch.minimum(torch.maximum(ys, y1.float()), y2.float() - 1.0).clamp(0.0, h - 1.0)
    xs = torch.minimum(torch.maximum(xs, x1.float()), x2.float() - 1.0).clamp(0.0, w - 1.0)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1i, x1i = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy, wx = (ys - y0)[..., :, None, None], (xs - x0)[..., None, :, None]
    bi = torch.arange(b)[:, None, None, None]
    at = lambda yy, xx: img[bi, yy[..., :, None], xx[..., None, :]]
    top = at(y0, x0) * (1 - wx) + at(y0, x1i) * wx
    bot = at(y1i, x0) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def _boxes(seed, h, w):
    rng = np.random.RandomState(seed)
    boxes = []
    for _ in range(10):
        x1, y1 = rng.randint(0, w - 4), rng.randint(0, h - 4)
        boxes.append([x1, y1, x1 + rng.randint(1, 12), y1 + rng.randint(1, 16)])
    boxes[:4] = [[0, 0, w, h], [w - 1, h - 1, w, h], [5, 5, 6, 6], [w - 6, h - 6, w + 10, h + 10]]
    return torch.tensor(boxes, dtype=torch.int32).view(2, 5, 4)


@pytest.mark.parametrize("size,s", [((40, 36), 32), ((128, 128), 32), ((9, 12), 8)])
def test_crop_resize_boxes_is_the_gather_form(size, s):
    img = _rand(2, *size, 3, grad=True)
    boxes = _boxes(sum(size), *size)
    got, want = crop_resize_boxes(img, boxes, s), _crop_gather(img, boxes, s)
    assert got.shape == want.shape == (2, 5, s, s, 3) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-6
    g_got, g_want = _grad(got, img), _grad(want, img)
    assert (g_got - g_want).abs().max().item() <= 1e-6 * g_want.abs().max().item()


#: autograd nodes whose backward scatters with atomics on the card
SCATTERING = ("ReflectionPad", "ReplicationPad", "IndexSelect", "Upsample", "IndexBackward",
              "IndexPut", "IndexAdd", "Gather", "Scatter", "Embedding")


def _graph_nodes(y):
    seen, todo = set(), [y.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


def _l2_loss(arch, output_size):
    net = arch(revisits=4, hidden_channels=16, output_size=output_size, device="cpu").train()
    net.set_dropout_masks(DropoutMasks())
    out = net(_rand(2, 4, 16, 16, 3))[:, 0]
    hr = _rand(*out.shape, seed=4)
    return (out - hr).abs().mean() + ssim_loss(out, hr).mean()


PATHS = {
    "srcnn": lambda: _l2_loss(SRCNN, 64),
    "srcnn_resized": lambda: _l2_loss(SRCNN, 48),
    "highresnet": lambda: _l2_loss(HighResNet, 64),
    "osm_crop": lambda: crop_resize_boxes(_rand(2, 40, 36, 3, grad=True),
                                          _boxes(0, 40, 36)).sum(),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_scattering_backward_is_left_on_the_train_paths(path):
    """The backward graphs of the SRCNN and HighResNet WorldStrat losses (the
    SSIM term, a resized SRCNN head) and of the OSM crop hold no node of
    the replaced ops."""
    nodes = _graph_nodes(PATHS[path]())
    assert any("Convolution" in n for n in nodes) or path == "osm_crop", nodes
    assert not [n for n in nodes if n.startswith(SCATTERING)], sorted(nodes)

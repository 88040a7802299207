"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips where no card is present. The
file imports only the port, torch and numpy, so it runs on a machine with
a card and without the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from satlas_sr_tpu_torch.archs import RRDBNet
from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
from satlas_sr_tpu_torch.ops.cuda.rdb import (PackedRDB, pack_weights, packed_shape, rdb,
                                              rdb_reference)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available here)")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full f32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = prev


def _weights(rng, nf, g):
    """Kaiming fan-in scale, so the conv branch is as large as x."""
    kernels = [torch.from_numpy((rng.randn(g if k < 4 else nf, nf + k * g, 3, 3)
                                 * np.sqrt(2 / (9 * (nf + k * g)))).astype(np.float32))
               for k in range(5)]
    biases = [torch.from_numpy(rng.randn(g if k < 4 else nf).astype(np.float32) * 0.01)
              for k in range(5)]
    return kernels, biases


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [32, 20])  # 20: ragged tiles, masked edges
def test_rdb_kernel_matches_plain(cuda_device, rng, hw):
    nf, g = 64, 32
    x = torch.from_numpy(rng.randn(3, hw, hw, nf).astype(np.float32)).to(cuda_device)
    kernels, biases = _weights(rng, nf, g)
    kernels = [k.to(cuda_device) for k in kernels]
    biases = [b.to(cuda_device) for b in biases]
    kb = [k.bfloat16() for k in kernels]
    packed = pack_weights(kernels, biases, nf, g, torch.float32)
    packed_b = pack_weights(kb, biases, nf, g, torch.bfloat16)
    before = rdb_mod.LAUNCHES
    with torch.no_grad():
        got = rdb(x, kernels, biases, nf, g, packed=packed)
        want = rdb_reference(x, kernels, biases, nf, g)
        got_b = rdb(x.bfloat16(), kb, biases, nf, g, packed=packed_b).float()
        want_b = rdb_reference(x.bfloat16().float(), [k.float() for k in kb], biases, nf, g)
    torch.cuda.synchronize()
    assert rdb_mod.LAUNCHES == before + 2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=1e-4)
    assert _branch_err(got_b, want_b, x.bfloat16().float()) <= 3e-2


@pytest.mark.cuda
def test_rdb_kernel_refuses_grad_and_bad_shapes(cuda_device, rng):
    kernels, biases = _weights(rng, 64, 32)
    kernels = [k.to(cuda_device).requires_grad_() for k in kernels]
    biases = [b.to(cuda_device) for b in biases]
    packed = pack_weights(kernels, biases, 64, 32, torch.float32)
    x = torch.zeros(1, 8, 8, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="forward-only"):
        rdb(x, kernels, biases, 64, 32, packed=packed)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bfloat16"):
        rdb(x.half(), kernels, biases, 64, 32, packed=packed)
    with torch.no_grad(), pytest.raises(ValueError, match="packed weights"):
        rdb(x, kernels, biases, 64, 32)


def _branch_err(got, want, x):
    """bf16 error beyond the output's own rounding (2^-8 |want|), over the
    peak of the conv branch want - x; a kernel returning x reads ~1."""
    excess = ((got - want).abs() - 2.0 ** -8 * want.abs()).clamp(min=0).max()
    return excess.item() / (want - x).abs().max().item()


@pytest.mark.cuda
def test_rrdb_bf16_chain_matches_plain(cuda_device, rng):
    """Three bf16 kernel calls on each other's outputs and the 0.2 outer
    residual (one RRDB), against the plain chain in f32."""
    nf, g = 64, 32
    x = torch.from_numpy(rng.randn(2, 32, 32, nf).astype(np.float32)).to(cuda_device).bfloat16()
    blocks = []
    for _ in range(3):
        kernels, biases = _weights(rng, nf, g)
        blocks.append(([k.to(cuda_device).bfloat16() for k in kernels],
                       [b.to(cuda_device) for b in biases]))
    with torch.no_grad():
        h = x
        for kb, bs in blocks:
            h = rdb(h, kb, bs, nf, g, packed=pack_weights(kb, bs, nf, g, torch.bfloat16))
        got = (h * 0.2 + x).float()
        h = x.float()
        for kb, bs in blocks:
            h = rdb_reference(h, [k.float() for k in kb], bs, nf, g)
        want = h * 0.2 + x.float()
    torch.cuda.synchronize()
    assert _branch_err(got, want, x.float()) <= 3e-2


@pytest.mark.cuda
def test_rrdb_f32_chain_matches_plain(cuda_device, rng):
    """Three f32 kernel calls (three TF32 products each) on each other's
    outputs and the 0.2 outer residual (one RRDB), against the plain chain
    with TF32 off."""
    nf, g = 64, 32
    x = torch.from_numpy(rng.randn(2, 32, 32, nf).astype(np.float32)).to(cuda_device)
    blocks = []
    for _ in range(3):
        kernels, biases = _weights(rng, nf, g)
        blocks.append(([k.to(cuda_device) for k in kernels], [b.to(cuda_device) for b in biases]))
    with torch.no_grad():
        h = x
        for ks, bs in blocks:
            h = rdb(h, ks, bs, nf, g, packed=pack_weights(ks, bs, nf, g, torch.float32))
        got = h * 0.2 + x
        h = x
        for ks, bs in blocks:
            h = rdb_reference(h, ks, bs, nf, g)
        want = h * 0.2 + x
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_rdb_f32_kernel_refuses_what_it_does_not_take(cuda_device, rng):
    kernels, biases = _weights(rng, 64, 32)
    kernels = [k.to(cuda_device) for k in kernels]
    biases = [b.to(cuda_device) for b in biases]
    x = torch.zeros(1, 8, 8, 64, device=cuda_device)
    with torch.no_grad():
        with pytest.raises(ValueError, match="x's dtype"):  # bf16-packed weights
            kb = [k.bfloat16() for k in kernels]
            rdb(x, kernels, biases, 64, 32, packed=pack_weights(kb, biases, 64, 32, torch.bfloat16))
        with pytest.raises(ValueError, match="do not fit"):  # bf16 layout cast to f32
            b_layout = pack_weights(kernels, biases, 64, 32, torch.bfloat16)
            rdb(x, kernels, biases, 64, 32,
                packed=b_layout._replace(weights=[w.float() for w in b_layout.weights]))
        for nf, g in [(64, 16), (96, 32)]:  # no wgmma width for 16, 96
            kk, bb = _weights(rng, nf, g)
            with pytest.raises(ValueError, match=r"in \(32, 64\)"):
                pack_weights(kk, bb, nf, g, torch.float32)
        # weights of the right shapes for g=16 reach the kernel, which refuses
        zeros = PackedRDB([torch.zeros(packed_shape(k, 64, 16, torch.float32), device=cuda_device)
                           for k in range(5)], torch.zeros(128, device=cuda_device))
        with pytest.raises(RuntimeError, match="nf and g of 32 or 64"):
            rdb(x, kernels, biases, 64, 16, packed=zeros)


@pytest.mark.cuda
def test_rdb_bf16_kernel_refuses_what_it_does_not_take(cuda_device, rng):
    kernels, biases = _weights(rng, 64, 32)
    kernels = [k.to(cuda_device) for k in kernels]
    kb = [k.bfloat16() for k in kernels]
    biases = [b.to(cuda_device) for b in biases]
    x = torch.zeros(1, 8, 8, 64, device=cuda_device, dtype=torch.bfloat16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="x's dtype"):  # f32-packed weights
            rdb(x, kb, biases, 64, 32, packed=pack_weights(kernels, biases, 64, 32, torch.float32))
        with pytest.raises(ValueError, match="do not fit"):  # f32 layout cast to bf16
            f32_layout = pack_weights(kernels, biases, 64, 32, torch.float32)
            rdb(x, kb, biases, 64, 32,
                packed=f32_layout._replace(weights=[w.bfloat16() for w in f32_layout.weights]))
        with pytest.raises(ValueError, match=r"in \(32, 64\)"):  # no wgmma width for g=16
            k16, b16 = _weights(rng, 64, 16)
            pack_weights(k16, b16, 64, 16, torch.bfloat16)


@pytest.mark.cuda
def test_rrdbnet_on_card_matches_cpu(cuda_device, rng):
    net = dict(num_in_ch=6, num_out_ch=3, num_feat=64, num_block=1, num_grow_ch=32)
    cpu = RRDBNet(seed=1, device="cpu", **net).eval()
    card = RRDBNet(seed=1, device=cuda_device, **net).eval()
    x = torch.from_numpy(rng.rand(2, 32, 32, 6).astype(np.float32))
    with torch.no_grad():
        want = cpu(x).numpy()
        got = card(x.to(cuda_device)).cpu().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

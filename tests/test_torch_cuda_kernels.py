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
from satlas_sr_tpu_torch.ops.cuda.rdb import (PackedRDB, Route, pack_weights, packed_shape,
                                              point_two, rdb, rdb_reference, rdb_route, route_key)


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
    """Under autograd the kernel runs inside RDBFunction (it used to refuse
    grad: the backward is ported now); bad dtypes and missing packs raise."""
    kernels, biases = _weights(rng, 64, 32)
    kernels = [k.to(cuda_device).requires_grad_() for k in kernels]
    biases = [b.to(cuda_device) for b in biases]
    packed = pack_weights(kernels, biases, 64, 32, torch.float32)
    x = torch.zeros(1, 8, 8, 64, device=cuda_device)
    before = rdb_mod.LAUNCHES
    y = rdb(x, kernels, biases, 64, 32, packed=packed)
    assert "RDBFunction" in type(y.grad_fn).__name__ and rdb_mod.LAUNCHES == before + 1
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bfloat16"):
        rdb(x.half(), kernels, biases, 64, 32, packed=packed)
    with torch.no_grad(), pytest.raises(ValueError, match="packed weights"):
        rdb(x, kernels, biases, 64, 32)


@pytest.mark.cuda
def test_rdb_function_gradients_match_plain(cuda_device, rng):
    """The kernel's forward + `rdb_backward` against autograd of the plain
    version given the kernel's activation pattern (where the two forwards
    round a pre-activation near 0 to opposite signs, the LeakyReLU's
    derivative rightly differs): every gradient within 1e-4 of its max."""
    import torch.nn.functional as F

    nf, g = 64, 32
    kernels, biases = _weights(rng, nf, g)
    params = [t.to(cuda_device).requires_grad_() for kb in zip(kernels, biases) for t in kb]
    kernels, biases = params[0::2], params[1::2]
    x = torch.from_numpy(rng.randn(2, 16, 16, nf).astype(np.float32)).to(cuda_device)
    x.requires_grad_()
    gy = torch.from_numpy(rng.randn(2, 16, 16, nf).astype(np.float32)).to(cuda_device)
    packed = pack_weights(kernels, biases, nf, g, torch.float32)
    before = rdb_mod.BACKWARDS
    got = torch.autograd.grad(rdb(x, kernels, biases, nf, g, packed=packed), [x, *params], gy)
    assert rdb_mod.BACKWARDS == before + 1
    with torch.no_grad():
        _, buf = rdb_mod._launch(x.detach(), packed, nf, g, keep_concat=True)
    slopes = [torch.where(buf[..., nf + k * g:nf + (k + 1) * g] > 0, 1.0, 0.2).permute(0, 3, 1, 2)
              for k in range(4)]
    feats = [x.permute(0, 3, 1, 2)]
    for k in range(5):
        y = F.conv2d(torch.cat(feats, 1), kernels[k], biases[k], padding=1)
        if k < 4:
            feats.append(y * slopes[k])
    want = torch.autograd.grad((y * 0.2 + feats[0]).permute(0, 2, 3, 1), [x, *params], gy)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


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


@pytest.mark.cuda
def test_rdb_kernel_matches_plain_at_the_whole_tile_shape(cuda_device, rng):
    """x [1, 512, 512, 64]: infer_grid's whole-tile mode, 1024 blocks a launch."""
    nf, g = 64, 32
    x = torch.from_numpy(rng.randn(1, 512, 512, nf).astype(np.float32)).to(cuda_device)
    kernels, biases = _weights(rng, nf, g)
    kernels = [k.to(cuda_device) for k in kernels]
    biases = [b.to(cuda_device) for b in biases]
    kb = [k.bfloat16() for k in kernels]
    with torch.no_grad():
        got = rdb(x, kernels, biases, nf, g, packed=pack_weights(kernels, biases, nf, g, torch.float32))
        want = rdb_reference(x, kernels, biases, nf, g)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        del got, want
        got_b = rdb(x.bfloat16(), kb, biases, nf, g,
                    packed=pack_weights(kb, biases, nf, g, torch.bfloat16)).float()
        want_b = rdb_reference(x.bfloat16().float(), [k.float() for k in kb], biases, nf, g)
    assert _branch_err(got_b, want_b, x.bfloat16().float()) <= 3e-2


@pytest.mark.cuda
def test_whole_tile_rrdbnet_on_card_matches_cpu(cuda_device, rng):
    """A small generator over one whole 512x512 tile: card (kernel) vs CPU."""
    net = dict(num_in_ch=6, num_out_ch=3, num_feat=32, num_block=1, num_grow_ch=32)
    cpu = RRDBNet(seed=2, device="cpu", **net).eval()
    card = RRDBNet(seed=2, device=cuda_device, **net).eval()
    x = torch.from_numpy(rng.rand(1, 512, 512, 6).astype(np.float32))
    with torch.no_grad():
        want = cpu(x).numpy()
        before = rdb_mod.LAUNCHES
        got = card(x.to(cuda_device)).cpu().numpy()
    assert rdb_mod.LAUNCHES == before + 3
    assert got.shape == (1, 2048, 2048, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exported_rrdbnet_launches_the_kernel(cuda_device, rng, dtype):
    """torch.export of the frozen model keeps the rdb op, whose CUDA
    implementation is the kernel: the loaded program launches it once per
    RDB and equals the live engine bit for bit (TF32 off in both)."""
    import io

    from satlas_sr_tpu_torch.archs.rrdbnet import freeze_rdbs
    from satlas_sr_tpu_torch.inference import InferenceEngine, UInt8Program

    engine = InferenceEngine(RRDBNet(num_in_ch=6, num_out_ch=3, num_feat=64, num_block=2,
                                     num_grow_ch=32, dtype=dtype, device="cpu"),
                             batch_size=4, device=cuda_device)
    program = UInt8Program(freeze_rdbs(engine.model), dtype).eval()
    x = torch.from_numpy((rng.rand(4, 32, 32, 6) * 255).astype(np.uint8))
    buf = io.BytesIO()
    torch.export.save(torch.export.export(program, (x.to(cuda_device),)), buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue())).module()
    before = rdb_mod.LAUNCHES
    with torch.inference_mode():
        got = loaded(x.to(cuda_device)).cpu().numpy()
    assert rdb_mod.LAUNCHES == before + 6
    np.testing.assert_array_equal(got, engine.run(x.numpy()))


ROUTES = [(torch.bfloat16, Route("cluster", 8)), (torch.bfloat16, Route("cluster", 16)),
          (torch.bfloat16, Route("bands", 32)), (torch.float32, Route("bands", 32)),
          (torch.float32, Route("bands", 16)), (torch.float32, Route("bands", 8))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", ROUTES, ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("shape", [(1, 32, 32), (2, 13, 32), (3, 18, 32), (2, 20, 20)])
def test_rdb_every_route_matches_plain(cuda_device, rng, dtype, route, shape):
    """Each route at the small shapes (whole chips, the 13- and 18-row bands
    of a chip over 4 ranks, ragged 20 x 20), with and without the concat
    buffer, against the plain version at chip_smoke.py's bars: f32 atol
    1e-4, rtol 1e-4 (TF32 off); bf16 _branch_err <= 3e-2. The kept concat
    holds x exactly and x1..x4 within 3e-2 of their peak (the bf16 route
    rounds each x_k to bf16 before the next conv reads it, where the plain
    version keeps f32)."""
    nf, g = 64, 32
    kernels, biases = _weights(rng, nf, g)
    kernels = [k.to(cuda_device).to(dtype) for k in kernels]
    biases = [b.to(cuda_device) for b in biases]
    packed = pack_weights(kernels, biases, nf, g, dtype)
    x = torch.from_numpy(rng.randn(*shape, nf).astype(np.float32)).to(cuda_device, dtype)
    rdb_mod.ROUTE_LAUNCHES.clear()
    with torch.no_grad():
        got = rdb_mod._launch(x, packed, nf, g, route=route).float()
        got_kept, buf = rdb_mod._launch(x, packed, nf, g, keep_concat=True, route=route)
        c = point_two(dtype)
        want, want_buf = rdb_mod.rdb_reference_with_concat(
            x.float(), [k.float() for k in kernels], biases, nf, g)
        if dtype == torch.bfloat16:
            want = rdb_reference(x.float(), [k.float() for k in kernels], biases, nf, g, c=c)
    torch.cuda.synchronize()
    assert dict(rdb_mod.ROUTE_LAUNCHES) == {route_key(dtype, route): 2}
    assert torch.equal(got_kept.float(), got)  # keeping the concat changes nothing
    assert torch.equal(buf[..., :nf], x)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=1e-4)
    else:
        assert _branch_err(got, want, x.float()) <= 3e-2
        kept, ref = buf[..., nf:].float(), want_buf[..., nf:]
        assert (kept - ref).abs().max().item() <= 3e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_rdb_function_gradients_through_the_cluster_route(cuda_device, rng):
    """RDBFunction at x [8, 32, 32, 64] in bf16 takes the cluster route, its
    forward keeping the concat; its gradients against autograd of the plain
    bf16 version with the kernel's activation pattern, every gradient within
    chip_smoke.py's bf16 train bar (5e-2 of its reference's max)."""
    import torch.nn.functional as F

    nf, g, dt = 64, 32, torch.bfloat16
    assert rdb_route(8, 32, 32, dt) == Route("cluster", 16)
    kernels, biases = _weights(rng, nf, g)
    params = [t.to(cuda_device).requires_grad_() for kb in zip(kernels, biases) for t in kb]
    kernels, biases = params[0::2], params[1::2]
    x = torch.from_numpy(rng.randn(8, 32, 32, nf).astype(np.float32)).to(cuda_device, dt)
    x.requires_grad_()
    gy = torch.from_numpy(rng.randn(8, 32, 32, nf).astype(np.float32)).to(cuda_device, dt)
    packed = pack_weights(kernels, biases, nf, g, dt)
    rdb_mod.ROUTE_LAUNCHES.clear()
    before = rdb_mod.BACKWARDS
    got = torch.autograd.grad(rdb(x, kernels, biases, nf, g, packed=packed), [x, *params], gy)
    assert rdb_mod.BACKWARDS == before + 1
    assert dict(rdb_mod.ROUTE_LAUNCHES) == {"bf16/cluster16": 1}
    c = point_two(dt)
    with torch.no_grad():
        _, buf = rdb_mod._launch(x.detach(), packed, nf, g, keep_concat=True)
    slopes = [torch.where(buf[..., nf + k * g:nf + (k + 1) * g] > 0, 1.0, c).to(dt)
              .permute(0, 3, 1, 2) for k in range(4)]
    feats = [x.permute(0, 3, 1, 2)]
    for k in range(5):
        y = F.conv2d(torch.cat(feats, 1), kernels[k].to(dt), biases[k].to(dt), padding=1)
        if k < 4:
            feats.append(y * slopes[k])
    want = torch.autograd.grad((y * c + feats[0]).permute(0, 2, 3, 1), [x, *params], gy)
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= 5e-2 * b.float().abs().max().item()


@pytest.mark.cuda
def test_cluster_route_is_one_launch_and_copies_nothing(cuda_device, rng):
    """bf16 x [1, 32, 32, 64]: one op call is one device kernel, the cluster
    kernel (no copy of x into a concat buffer, no other launch)."""
    from torch.profiler import ProfilerActivity, profile

    kernels, biases = _weights(rng, 64, 32)
    kb = [k.to(cuda_device).bfloat16() for k in kernels]
    packed = pack_weights(kb, [b.to(cuda_device) for b in biases], 64, 32, torch.bfloat16)
    x = torch.zeros(1, 32, 32, 64, device=cuda_device, dtype=torch.bfloat16)
    with torch.no_grad():
        rdb_mod.rdb_op(x, packed.weights, packed.bias, 64, 32)  # built and warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rdb_mod.rdb_op(x, packed.weights, packed.bias, 64, 32)
            torch.cuda.synchronize()
    kernels_run = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert len(kernels_run) == 1 and "rdb_cluster_wgmma" in kernels_run[0], kernels_run

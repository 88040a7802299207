"""The port's SSIM (ops/ssim.py), SSIMLoss and GAN regularizers against the
JAX package's, on the CPU in float32.

- `ssim_map` / `ssim_loss`: within 1e-6 absolute on random images and on
  near-constant ones (magnitude ~1, variance below C2 = 9e-4, where a filter
  that errs in E[x^2] by more than C2 sends the map to inf); the port sums
  the window in XLA's order, so the maps agree bit for bit here.
- `SSIMLoss`: within 1e-6 relative, and finite with a finite gradient on
  the near-constant pair.
- r1_penalty, gradient_penalty_loss and g_path_regularize on a small U-Net
  SN discriminator (a small RRDBNet for the path length), the port's seeded
  weights carried into flax by the JAX package's reference-.pth importers
  (no flax init: it takes ~10-30 s a network here), the same alpha / noise
  draw on both sides: within 1e-5 relative. A D penalty that misses that
  is held by the cancelling-sum rule of test_torch_step_bars.py on the D's
  spectral norms (`assert_penalty_matches`: the seeded D's conv7 sigma
  cancels 400-fold): each side's eight sigmas within the summation bounds
  of their float64 sums, and the port's penalty within 1e-5 relative of
  JAX's recomputed with the port's sigmas (`jax_sigmas`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.archs import build_arch
from satlas_sr_tpu.losses import basic as jax_basic
from satlas_sr_tpu.losses import regularizers as jax_reg
from satlas_sr_tpu.ops import ssim as jax_ssim
from satlas_sr_tpu.utils import torch_io as jax_torch_io
from satlas_sr_tpu_torch.archs import RRDBNet, UNetDiscriminatorSN
from satlas_sr_tpu_torch.losses import (build_loss, g_path_regularize, gradient_penalty_loss,
                                        r1_penalty)
from satlas_sr_tpu_torch.ops import ssim
from test_torch_step_bars import jax_sigmas, sums_within_bound
from torch_threads import two_torch_threads  # noqa: F401


def _pair(rng, kind, shape=(2, 32, 24, 3)):
    if kind == "random":
        return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)
    base = 0.95 + 0.01 * rng.rand(1, 1, 1, shape[-1])  # magnitude ~1, var << C2
    return ((base + 0.01 * rng.randn(*shape)).astype(np.float32),
            (base + 0.01 * rng.randn(*shape)).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("fn", ["ssim_map", "ssim_loss"])
@pytest.mark.parametrize("kind", ["random", "near_constant"])
def test_ssim_maps_match_jax(rng, fn, kind):
    a, b = _pair(rng, kind)
    got = getattr(ssim, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(getattr(jax_ssim, fn)(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == a.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6


def test_ssim_casts_bfloat16_inputs_to_float32(rng):
    a, b = _pair(rng, "random")
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = ssim.ssim_map(ta, tb)
    assert got.dtype == torch.float32
    assert torch.equal(got, ssim.ssim_map(ta.float(), tb.float()))


@pytest.mark.parametrize("kind", ["random", "near_constant"])
def test_ssim_loss_matches_jax_and_has_a_finite_gradient(rng, kind):
    a, b = _pair(rng, kind)
    opt = {"type": "SSIMLoss", "loss_weight": 0.7}
    x = torch.from_numpy(a).requires_grad_()
    got = build_loss(opt)(x, torch.from_numpy(b))
    want = jax_basic.build_loss(opt)(jnp.asarray(a), jnp.asarray(b))
    assert _rel(got.detach(), want) <= 1e-6
    got.backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


def _numpy(state):
    return {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def disc():
    port = UNetDiscriminatorSN(3, 4, seed=1, device="cpu")
    net = build_arch({"type": "SSR_UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 4})
    variables = jax_torch_io.unet_disc_from_torch(_numpy(port.state_dict()))
    return (lambda x: net.apply(variables, x)), (lambda x: port(x)), port


def _sigmas(port):
    """The port D's eight spectral-norm sigmas as its forward computes them
    (u, v held: no power iteration), and each one's terms u_i W_ij v_j."""
    sd = port.state_dict()
    u, w, v = ([sd[f"conv{i}.weight_{k}"] for i in range(1, 9)] for k in ("u", "orig", "v"))
    return ([torch.dot(a, b.flatten(1) @ c).item() for a, b, c in zip(u, w, v)],
            [a[:, None] * b.flatten(1) * c[None, :] for a, b, c in zip(u, w, v)])


def assert_penalty_matches(got, jax_penalty, port, what):
    """The port's penalty `got` within 1e-5 relative of JAX's
    (`jax_penalty(sigmas)`: JAX's value and its sigmas, with `sigmas` in
    place of its own where given); where not, the cancelling-sum rule of
    test_torch_step_bars.py on the D's spectral norms: each side's sigmas
    within the summation bounds of their float64 sums, and the port's
    penalty within 1e-5 relative of JAX's recomputed with the port's."""
    want, jax_sigma = jax_penalty(None)
    err = _rel(got, want)
    if err <= 1e-5:
        print(f"{what}: bar, ratio to it {err / 1e-5:.3g}")
        return
    sigmas, terms = _sigmas(port)
    sums_within_bound(sigmas, terms, (what, "port sigmas"))
    sums_within_bound(np.asarray(jax_sigma), terms, (what, "JAX sigmas"))
    again, _ = jax_penalty(sigmas)
    ratio = _rel(got, again) / 1e-5
    print(f"{what}: cancelling_sum, JAX on the port's sigmas {ratio:.3g} of the bar "
          f"(on its own {err / 1e-5:.3g})")
    assert ratio <= 1.0, (what, _rel(got, again))


def _jax_penalty(fn, *args):
    """`fn(*args)` under jax.jit, with its sigmas: a function of the
    sigmas to replay (None: JAX's own)."""
    def run(replay):
        def traced(*a):
            with jax_sigmas(replay) as record:
                return fn(*a), record
        value, record = jax.jit(traced)(*args)
        return float(value), record
    return run


def test_r1_penalty_matches_jax(rng, disc):
    jax_d, port_d, port = disc
    real = rng.rand(2, 32, 32, 3).astype(np.float32)
    got = r1_penalty(port_d, torch.from_numpy(real))
    assert got.requires_grad  # differentiable in D's weights
    assert_penalty_matches(got.detach(), _jax_penalty(lambda r: jax_reg.r1_penalty(jax_d, r),
                                                      jnp.asarray(real)), port, "r1_penalty")


@pytest.mark.parametrize("weighted", [False, True])
def test_gradient_penalty_matches_jax(rng, disc, weighted):
    jax_d, port_d, port = disc
    real, fake = (rng.rand(2, 32, 32, 3).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(3)
    alpha = np.array(jax.random.uniform(key, (2, 1, 1, 1)))  # the JAX function's own draw
    weight = rng.rand(2, 32, 32, 3).astype(np.float32) + 0.5 if weighted else None
    got = gradient_penalty_loss(port_d, torch.from_numpy(real), torch.from_numpy(fake),
                                alpha=torch.from_numpy(alpha),
                                weight=None if weight is None else torch.from_numpy(weight))
    want = _jax_penalty(lambda r, f, w: jax_reg.gradient_penalty_loss(jax_d, r, f, key, w),
                        jnp.asarray(real), jnp.asarray(fake),
                        None if weight is None else jnp.asarray(weight))
    assert_penalty_matches(got.detach(), want, port, ("gradient_penalty", weighted))


def test_gradient_penalty_draws_alpha_from_the_generator(rng, disc):
    _, port_d, _ = disc
    real, fake = (torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32)) for _ in range(2))
    a = gradient_penalty_loss(port_d, real, fake, generator=torch.Generator().manual_seed(5))
    b = gradient_penalty_loss(port_d, real, fake, generator=torch.Generator().manual_seed(5))
    alpha = torch.rand((2, 1, 1, 1), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(a, gradient_penalty_loss(port_d, real, fake, alpha=alpha))


def test_path_length_regularizer_matches_jax(rng):
    net_opt = {"type": "SSR_RRDBNet", "num_in_ch": 6, "num_out_ch": 3, "num_feat": 8,
               "num_block": 1, "num_grow_ch": 4}
    net = build_arch(net_opt)
    port = RRDBNet(num_in_ch=6, num_out_ch=3, num_feat=8, num_block=1, num_grow_ch=4, seed=2,
                   device="cpu")
    variables = jax_torch_io.rrdbnet_from_torch(_numpy(port.state_dict()), num_block=1)
    latents = rng.rand(2, 32, 32, 6).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.array(jax.random.normal(key, (2, 128, 128, 3)))  # the JAX function's own draw
    want = jax.jit(lambda z: jax_reg.g_path_regularize(lambda x: net.apply(variables, x), z, key,
                                                       jnp.float32(0.5)))(jnp.asarray(latents))
    got = g_path_regularize(port, torch.from_numpy(latents), torch.tensor(0.5),
                            noise=torch.from_numpy(noise))
    for g, w in zip(got, want):
        assert _rel(g.detach(), w) <= 1e-5
    assert not got[1].requires_grad and not got[2].requires_grad

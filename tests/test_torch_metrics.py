"""The port's metrics (satlas_sr_tpu_torch.metrics) against the JAX package's.

The numpy metrics (psnr, ssim, cpsnr) are copies and must agree within
1e-10 for every crop_border / test_y_channel case. The device-batched
fast_eval (torch, float32) must agree with the JAX fast_eval within 1e-4 dB
(PSNR) and 1e-6 (SSIM), identical images giving inf PSNR in both, and with
the float64 numpy metrics within 1e-3 dB and 1e-4 (the chip's gate). The
tower metrics (LPIPS, CLIPScore) run through the dispatcher on the device
it is given (tests/test_torch_towers.py holds them in detail).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from satlas_sr_tpu import metrics as jax_metrics
from satlas_sr_tpu.metrics import fast_eval as jax_fast
from satlas_sr_tpu_torch import metrics
from satlas_sr_tpu_torch.metrics import fast_eval
from torch_threads import two_torch_threads  # noqa: F401


def _pair(h=40, w=36, c=3, noise=20, seed=11):
    """A seeded (sr, gt) uint8 pair: the same data whatever ran before."""
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 256, size=(h, w, c)).astype(np.uint8)
    sr = np.clip(gt.astype(np.int32) + rng.randint(-noise, noise + 1, size=gt.shape), 0, 255)
    return sr.astype(np.uint8), gt


@pytest.mark.parametrize("metric", ["calculate_psnr", "calculate_ssim", "calculate_cpsnr"])
@pytest.mark.parametrize("crop_border,y", [(0, False), (4, False), (4, True), (2, True)])
def test_numpy_metrics_equal_jax(metric, crop_border, y):
    sr, gt = _pair()
    opt = {"type": metric, "crop_border": crop_border, "test_y_channel": y}
    got = metrics.calculate_metric({"img": sr, "img2": gt}, opt)
    want = jax_metrics.calculate_metric({"img": sr, "img2": gt}, opt)
    assert abs(got - want) <= 1e-10, (got, want)


def test_cpsnr_finds_a_shift_and_a_brightness_bias():
    gt = np.random.RandomState(12).randint(0, 200, size=(48, 48, 3)).astype(np.uint8)
    # shifted and brighter by 7 levels; the search (offsets 0..8 of both
    # crops) reaches even relative shifts only
    sr = np.roll(gt, (4, -2), axis=(0, 1)) + 7
    opt = {"type": "calculate_cpsnr", "crop_border": 4}
    got = metrics.calculate_metric({"img": sr.astype(np.uint8), "img2": gt}, opt)
    assert got == jax_metrics.calculate_metric({"img": sr.astype(np.uint8), "img2": gt}, opt)
    assert got == float("inf")  # the shift search and the bias correction undo both
    psnr = metrics.calculate_psnr(sr.astype(np.uint8), gt, crop_border=4)
    assert psnr < 20


def test_identical_images_give_inf():
    _, gt = _pair()
    for fn in (metrics.calculate_psnr, metrics.calculate_cpsnr):
        assert fn(gt, gt, crop_border=4) == float("inf")
    assert metrics.calculate_ssim(gt, gt, crop_border=4) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("crop_border", [0, 4])
def test_fast_eval_matches_jax_and_numpy(crop_border):
    pairs = [_pair(48, 48, noise=n, seed=n) for n in (3, 20, 60)]
    sr = np.stack([p[0] for p in pairs] + [pairs[0][1]])  # the last: identical to its gt
    gt = np.stack([p[1] for p in pairs] + [pairs[0][1]])
    for name in ("calculate_psnr", "calculate_ssim"):
        opt = {"type": name, "crop_border": crop_border, "test_y_channel": False}
        got = fast_eval.fast_metric_fn(opt)(torch.from_numpy(sr), torch.from_numpy(gt)).numpy()
        want = np.asarray(jax_fast.fast_metric_fn(opt)(jnp.asarray(sr), jnp.asarray(gt)))
        ref = np.asarray([metrics.calculate_metric({"img": a, "img2": b}, opt)
                          for a, b in zip(sr, gt)])
        assert got.dtype == np.float32
        tol_jax, tol_ref = (1e-4, 1e-3) if name == "calculate_psnr" else (1e-6, 1e-4)
        if name == "calculate_psnr":
            assert np.isinf(got[-1]) and np.isinf(want[-1]) and np.isinf(ref[-1])
            got, want, ref = got[:-1], want[:-1], ref[:-1]
        np.testing.assert_allclose(got, want, atol=tol_jax, rtol=0)
        np.testing.assert_allclose(got, ref, atol=tol_ref, rtol=0)


def test_fast_eval_covers_what_jax_covers():
    for opt in ({"type": "calculate_psnr", "test_y_channel": True},
                {"type": "calculate_cpsnr"}, {"type": "calculate_ssim", "test_y_channel": True}):
        assert fast_eval.fast_metric_fn(opt) is None
        assert jax_fast.fast_metric_fn(opt) is None
    assert fast_eval.fast_metric_fn({"type": "calculate_ssim", "crop_border": 4}) is not None


@pytest.mark.parametrize("opt", [{"type": "calculate_lpips", "lpips_model": "vgg"},
                                 {"type": "calculate_clipscore", "clip_model": "test-tiny-siglip"}],
                         ids=["lpips", "clipscore"])
def test_tower_metrics_run_through_the_dispatcher(opt):
    """The registry's tower metrics, as a config names them, on the device the
    dispatcher is given: the JAX package's number within 1e-5, and a random
    tower reported as such (the `(untrained-tower)` tag's source)."""
    sr, gt = _pair(48, 48)
    got = metrics.calculate_metric({"img": sr, "img2": gt}, opt, device="cpu")
    want = jax_metrics.calculate_metric({"img": sr, "img2": gt}, opt)
    assert np.isfinite(got) and abs(got - want) <= 1e-5, (got, want)
    assert metrics.metric_tower_pretrained(opt) is False
    assert jax_metrics.metric_tower_pretrained(opt) is False
    assert metrics.metric_tower_pretrained({"type": "calculate_psnr"}) is None

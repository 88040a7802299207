"""FLOP counts against the hand counts, and the roofline and mfu arithmetic."""

import importlib.util
import math

import pytest

from portbench import flops, peaks, trace
from portbench.tests.tiny import ROOT

NET = dict(num_in_ch=24, num_out_ch=3, num_feat=64, num_grow_ch=32, num_block=23)
H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "portbench/metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_rdb_macs_a_pixel():
    assert flops.rdb_macs_per_pixel(64, 32) == 239_616


def test_generator_flops_an_image():
    """36.74 GFLOP an image (36.75 by a rounder count): 69 blocks at 239,616
    MACs a pixel on 32x32 (33.86 GFLOP), and the heads (2.88 GFLOP:
    conv_first and conv_body at 32x32, conv_up1 at 64x64, conv_up2, conv_hr
    and conv_last at 128x128)."""
    macs = (1024 * 24 * 64 * 9 + 69 * 1024 * 239_616 + 1024 * 64 * 64 * 9
            + 4096 * 64 * 64 * 9 + 2 * 16384 * 64 * 64 * 9 + 16384 * 64 * 3 * 9)
    assert flops.rrdbnet_flops_per_image(NET) == 2 * macs
    assert 2 * macs / 1e9 == pytest.approx(36.75, abs=0.02)


def test_flop_counter_sees_one_block_as_the_shapes_say():
    import torch

    from portbench.reference import nets

    sd = {f"b.conv{k + 1}.{p}": torch.empty(s, device="meta")
          for k in range(5) for p, s in (("weight", ((32 if k < 4 else 64), 64 + 32 * k, 3, 3)),
                                         ("bias", ((32 if k < 4 else 64),)))}
    x = torch.empty(2, 64, 8, 8, device="meta")

    def block():
        feats = [x]
        for k in range(1, 5):
            feats.append(torch.nn.functional.conv2d(torch.cat(feats, 1), sd[f"b.conv{k}.weight"],
                                                    sd[f"b.conv{k}.bias"], padding=1))
        torch.nn.functional.conv2d(torch.cat(feats, 1), sd["b.conv5.weight"], padding=1)

    assert flops.count(block) == flops.rdb_flops(2, 8, 8, 64, 32)
    assert nets  # the reference module the counts run over imports cleanly


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roofline_share_is_100_at_the_bound_and_under_it_above(dtype):
    """A kernel that takes exactly the least time reads 100%; slower reads
    less. The bound is met by no card, so no run can read more."""
    shape = (64, 32, 32, 64)
    size = 2 if dtype == "bfloat16" else 4
    bound = flops.roofline_s(flops.rdb_flops(*shape[:3], 64, 32),
                             flops.rdb_bytes(*shape[:3], 64, 32, size),
                             peaks.peak(H100, dtype), peaks.peak(H100, "hbm_bytes_per_s"))
    for slower in (1.0, 3.0):
        ns = math.ceil(bound * slower * 1e9)
        tr = trace.Trace([("k", 0, ns)], {"portbench::rdb": [(0, ns)]}, [], (0, ns))
        tr.busy = [(0, ns)]
        ctx = {"kind": "infer", "trace": tr, "rdb_calls": [(shape, None)], "device_kind": H100,
               "traffic": {"compute_dtype": dtype}, "rdb_range": "portbench::rdb",
               "config": {"network_g": NET}}
        share = reader("rdb_roofline_share.infer")(ctx)
        assert share <= 100.0 and share == pytest.approx(100.0 / slower, rel=1e-4)
    assert bound == pytest.approx(flops.rdb_flops(64, 32, 32, 64, 32) / peaks.peak(H100, dtype))


def test_mfu_is_100_at_the_peak_and_unknown_cards_read_nothing():
    per = flops.rrdbnet_flops_per_image(NET)
    peak = peaks.peak(H100, "bfloat16")
    ctx = {"kind": "infer", "window_s": 2.0, "images": 2.0 * peak / per, "device_kind": H100,
           "traffic": {"compute_dtype": "bfloat16"}, "config": {"network_g": NET, "lr_size": 32}}
    assert reader("infer_mfu")(ctx) == pytest.approx(100.0)
    assert reader("infer_mfu")({**ctx, "device_kind": "cpu"}) is None
    assert reader("rdb_roofline_share.infer")({**ctx, "trace": None}) is None

"""rdb_roofline_share.infer: the dense blocks' least time on the card over
their device time, in %.

Work from shapes (portbench.flops): 2 B H W 239,616 FLOPs a call at nf 64,
g 32; bytes: x in, the output out, weights and biases once. Peak: the
cell's dtype's tensor-core rate (portbench.peaks) and HBM. Time: the
device time of every kernel launched inside the benchmark's range around
each ResidualDenseBlock call (any route counts) over the profiled stretch.
"""

from portbench import flops, peaks, trace


def read(ctx):
    tr, calls = ctx.get("trace"), ctx.get("rdb_calls")
    if ctx.get("kind") != "infer" or tr is None or not calls:
        return None
    dtype = ctx["traffic"]["compute_dtype"]
    pf = peaks.peak(ctx["device_kind"], dtype)
    pb = peaks.peak(ctx["device_kind"], "hbm_bytes_per_s")
    if pf is None or pb is None:
        return None
    net = ctx["config"]["network_g"]
    nf, g = int(net["num_feat"]), int(net["num_grow_ch"])
    size = 2 if dtype == "bfloat16" else 4
    bound = sum(flops.roofline_s(flops.rdb_flops(b, h, w, nf, g),
                                 flops.rdb_bytes(b, h, w, nf, g, size), pf, pb)
                for (b, h, w, _), _ in calls)
    busy, _ = trace.inside(tr, ctx["rdb_range"])
    return 100.0 * bound / busy if busy > 0 else None

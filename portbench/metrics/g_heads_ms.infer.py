"""g_heads_ms.infer: device ms a batch of the compute kernels outside the
dense blocks' ranges (the generator's heads, the uint8 program's casts and
quantisation) over the profiled stretch."""

from portbench import trace


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "infer" or tr is None or not ctx.get("trace_batches"):
        return None
    _, outside = trace.inside(tr, ctx["rdb_range"])
    return 1e3 * outside / ctx["trace_batches"]

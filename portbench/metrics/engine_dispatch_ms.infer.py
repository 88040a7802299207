"""engine_dispatch_ms.infer: host ms in `BatchRunner.dispatch` a batch, mean
over the window (pad, pin, the H2D enqueue and the forward's launches)."""


def read(ctx):
    disp = ctx.get("dispatch_s")
    if ctx.get("kind") != "infer" or not disp:
        return None
    return 1e3 * sum(disp) / len(disp)

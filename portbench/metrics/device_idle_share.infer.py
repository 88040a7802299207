"""device_idle_share.infer: 100 x (1 - the union of the device's kernel and
copy intervals over the profiled stretch's span)."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "infer" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

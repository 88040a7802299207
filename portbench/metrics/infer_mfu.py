"""infer_mfu: the generator's FLOPs an image, counted by flop_counter over
the plain reference, times the images of the window over its seconds, as a
share of the cell's dtype's peak (portbench.peaks), in %."""

from portbench import flops, peaks


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx.get("window_s"):
        return None
    pf = peaks.peak(ctx["device_kind"], ctx["traffic"]["compute_dtype"])
    if pf is None:
        return None
    per_image = flops.rrdbnet_flops_per_image(ctx["config"]["network_g"], ctx["config"]["lr_size"])
    return 100.0 * per_image * ctx["images"] / ctx["window_s"] / pf

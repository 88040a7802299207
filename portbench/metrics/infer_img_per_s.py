"""infer_img_per_s: images returned to the host over the whole window."""


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx.get("window_s"):
        return None
    return ctx["images"] / ctx["window_s"]

"""setup_s: process start to the first timed batch or step (host clock)."""


def read(ctx):
    return ctx.get("setup_s")

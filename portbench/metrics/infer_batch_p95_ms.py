"""infer_batch_p95_ms: the 95th percentile over every batch of the window,
each timed from the start of its `dispatch` to the return of its `fetch`
(numpy's linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    lat = ctx.get("batch_latency_s")
    if ctx.get("kind") != "infer" or not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3

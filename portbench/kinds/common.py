"""What the drivers share: the device, the clock, the profiled stretch."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List

import torch

from .. import trace as trace_mod

clock = time.perf_counter


def setup_note(t0: float, marks) -> str:
    """`setup: imports 3.1 s, weights 0.2 s, ...` from (phase, clock at its end)."""
    parts, prev = [], t0
    for name, t in marks:
        parts.append(f"{name} {t - prev:.2f} s")
        prev = t
    return "setup: " + ", ".join(parts)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_kind(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def memory_peak(device) -> int:
    dev = torch.device(device)
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def ranges_on(modules: List[torch.nn.Module], name: str, calls: List):
    """A record_function range `name` around every forward of `modules`;
    each call's input is appended to `calls` as (shape, dtype)."""
    open_ranges = []

    def pre(mod, args):
        calls.append((tuple(args[0].shape), args[0].dtype))
        r = torch.autograd.profiler.record_function(name)
        r.__enter__()
        open_ranges.append(r)

    def post(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    handles = []
    for m in modules:
        handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def profiled(warm: Callable[[], None], active: Callable[[], None], device):
    """Trace `active` after one traced warm-up call (CUPTI starts
    asynchronously, so a session's first kernels can reach it partly);
    returns the trace.Trace of `active`, or None without device work."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        sync(device)
        prof.step()
        active()
        sync(device)
        prof.step()
    return trace_mod.read(prof)

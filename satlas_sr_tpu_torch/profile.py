"""Profiling CLI: trace a config's hot program on the card.

    python -m satlas_sr_tpu_torch.profile -opt options/esrgan_s2naip_urban.yml
    python -m satlas_sr_tpu_torch.profile -opt options/infer_example.yml --steps 5

Counterpart of satlas_sr_tpu/profile.py. Builds the config's program as the
train and infer CLIs do, on synthetic data (no dataset; an infer config's
weights as configured), runs it once outside the window (kernel build, CUDA
module loading, cuDNN's algorithm choice), then records `--steps`
steady-state steps with torch.profiler and prints a summary: ms a step, the
top device kernels by time with their share and launches a step, and the
device's idle share, one minus the union of the kernel intervals over the
window. The raw trace goes to `--out` as a Chrome trace (chrome://tracing,
Perfetto). On the CPU the summary lists CPU ops instead, and says so; on a
card a trace without device time is a failure (exit 1), never a silent
fallback to host times.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .warmup import _sync


def _train_program(opt: dict, device: torch.device):
    from .models import build_model
    from .warmup import _synth_batch

    model = build_model(opt, device=device)
    ds = opt["datasets"]["train"]
    rows = int(ds.get("batch_size_per_gpu", 16))
    batch = _synth_batch(ds, int(opt.get("scale", 4)), rows,
                         with_old=bool(ds.get("old_naip_path")))
    it = iter(range(1, 1 << 30))
    return (lambda: model.train_iter(batch, next(it))), f"train step ({rows} rows)"


def _infer_program(opt: dict, device: torch.device):
    from .infer import load_infer_variables
    from .inference import InferenceEngine
    from .utils.infer_utils import channels_per_frame
    from .utils.model_utils import build_network, uses_3d_input

    n = int(opt["n_lr_images"])
    use_3d = uses_3d_input(opt["network_g"]["type"])
    model = build_network(opt, device="cpu")
    engine = InferenceEngine(model, load_infer_variables(opt, model),
                             batch_size=int(opt.get("batch_size", 64)), use_3d=use_3d,
                             n_frames=n, matmul_precision=str(opt.get("matmul_precision", "highest")),
                             device=device)
    c = 3 if use_3d else channels_per_frame(opt.get("s2_bands"))
    x = (np.random.RandomState(0).rand(engine.batch_size, 32, 32, n * c) * 255).astype(np.uint8)
    return (lambda: engine.fetch(engine.dispatch(x))), f"infer program (batch {engine.batch_size})"


#: the utility events torch.profiler leaves out of `prof.events()`
_UTILITY_EVENTS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def device_busy(prof):
    """([(name, us)] of the device events, busy us, window us) of a
    torch.profiler trace: busy is the union of the device kernels' and
    copies' intervals, the window the span of all events. None when the
    trace holds no device time. It reads the raw kineto events, the ones
    `prof.events()` is built from: building those per-op objects takes
    seconds for a train step's trace."""
    from torch.autograd import DeviceType

    flag = lambda e, name: getattr(e, name, lambda: False)()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() not in _UTILITY_EVENTS and not flag(e, "is_hidden_event")]
    # device work only: not the user annotations on the device's timeline
    # (ProfilerStep#N, Optimizer.step#...), which span the gaps between kernels
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and not flag(e, "is_user_annotation")]
    if not kernels:
        return None
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = (max(e.end_ns() for e in events) - min(e.start_ns() for e in events)) / 1e3
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e3) for e in kernels], busy, window


def summarize(prof, steps: int, device: torch.device, top: int = 15) -> Optional[Dict[str, Any]]:
    """Print the window's table; returns {"kernels": {name: [ms a step,
    launches a step]}, "ms_per_step", "busy_ms_per_step", "idle_share",
    "device"}, or None when a card's trace holds no device time."""
    steps = max(steps, 1)
    if device.type != "cuda":
        rows = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        total = sum(a.self_cpu_time_total for a in rows)
        print(f"\ncpu run: CPU ops by self time (no device in this run), {steps} steps, "
              f"{total / 1e3 / steps:.2f} ms/step of op time")
        print(f"{'op':<58} {'ms/step':>9} {'%':>6} {'calls/step':>10}")
        for a in rows[:top]:
            print(f"{a.key[:58]:<58} {a.self_cpu_time_total / 1e3 / steps:>9.3f} "
                  f"{100 * a.self_cpu_time_total / max(total, 1e-9):>5.1f}% "
                  f"{a.count / steps:>10.1f}")
        return {"device": "cpu", "ms_per_step": total / 1e3 / steps,
                "ops": {a.key: [a.self_cpu_time_total / 1e3 / steps, a.count / steps]
                        for a in rows}}
    traced = device_busy(prof)
    if traced is None:
        print("profile: the trace holds no device time on a card (CUPTI did not trace it)")
        return None
    kernels, busy, window = traced
    by_name: Dict[str, list] = {}
    for name, us in kernels:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += us
        t[1] += 1
    total = sum(t for t, _ in by_name.values())
    summary = {"device": torch.cuda.get_device_name(device),
               "ms_per_step": window / 1e3 / steps, "busy_ms_per_step": busy / 1e3 / steps,
               "idle_share": 1 - busy / window,
               "kernels": {n: [t / 1e3 / steps, c / steps] for n, (t, c) in by_name.items()}}
    print(f"\n{summary['device']}: {summary['ms_per_step']:.3f} ms/step over the window, device "
          f"busy {summary['busy_ms_per_step']:.3f} ms/step, idle share "
          f"{summary['idle_share']:.4f} ({steps} steps traced)")
    print(f"{'device kernel':<70} {'ms/step':>9} {'%':>6} {'launches/step':>13}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{name[:70]:<70} {t / 1e3 / steps:>9.3f} {100 * t / max(total, 1e-9):>5.1f}% "
              f"{c / steps:>13.1f}")
    return summary


def run_profile(opt_path: str, steps: int = 3, out: str = "profile_trace", mode: str = "auto",
                device="cuda", force_yml=None) -> Optional[Dict[str, Any]]:
    """Build, run once, trace `steps` steps, write the Chrome trace under
    `out` and return `summarize`'s dict (None: no device time on a card)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from .utils.lint import report_lint
    from .utils.options import apply_force_yml, parse_options, yaml_load

    device = resolve_device(device)
    raw = yaml_load(opt_path)
    if mode == "auto":
        mode = "infer" if "data_dir" in raw else "train"
    report_lint(raw, kind=mode)
    if mode == "train":
        argv = ["-opt", opt_path] + (["--force_yml", *force_yml] if force_yml else [])
        opt, _ = parse_options(os.getcwd(), is_train=True, argv=argv)
        step, what = _train_program(opt, device)
    else:
        apply_force_yml(raw, force_yml)
        step, what = _infer_program(raw, device)
    t0 = time.time()
    step()  # kernel build, module loading and cuDNN's choice, outside the window
    _sync(device)
    print(f"built and ran the {what} once in {time.time() - t0:.1f}s")

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    # one traced warm-up step before the window: a session's first kernels
    # can reach the trace partly (CUPTI starts asynchronously)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
        for i in range(steps + 1):
            step()
            if i in (0, steps):  # the window holds its own steps' device work
                _sync(device)
            prof.step()
    os.makedirs(out, exist_ok=True)
    trace = os.path.join(out, f"{mode}_trace.json")
    prof.export_chrome_trace(trace)
    summary = summarize(prof, steps, device)
    print(f"\nraw trace: {trace}")
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-opt", type=str, required=True)
    parser.add_argument("--steps", type=int, default=3,
                        help="steady-state steps to trace (the first run excluded)")
    parser.add_argument("--out", type=str, default="profile_trace",
                        help="directory of the Chrome trace")
    parser.add_argument("--mode", choices=["auto", "train", "infer"], default="auto")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="override yml entries, e.g. compute_dtype=bfloat16")
    args = parser.parse_args(argv)
    summary = run_profile(args.opt, args.steps, args.out, args.mode, args.device,
                          args.force_yml)
    return 0 if summary is not None else 1


if __name__ == "__main__":
    sys.exit(main())

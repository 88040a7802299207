"""Reading a torch.profiler window: device time, idle gaps, and the device
time of the kernels that ran inside the benchmark's own ranges.

The benchmark opens a `record_function` range around every call of a
module it measures (`portbench::rdb`, from forward hooks on the dense
blocks). The profiler puts each range on the device's timeline too,
spanning the kernels launched inside it; on one stream those are exactly
the range's kernels, whatever their names. An idle gap is named by the
innermost `portbench::` range and host event over it.

It reads the raw kineto events (the port's profile.py `device_busy` reads
them the same way): busy time is the union of the kernels' and copies'
intervals, the window the span of all events.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

UTILITY_EVENTS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


@dataclass
class Trace:
    kernels: List[Tuple[str, int, int]]        # device work: (name, start ns, end ns)
    device_ranges: Dict[str, List[Tuple[int, int]]]  # benchmark ranges on the device
    host: List[Tuple[str, int, int, bool]]     # host events: (name, start, end, is a range)
    window_ns: Tuple[int, int]
    busy: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9


def _flag(e, name: str) -> bool:
    return bool(getattr(e, name, lambda: False)())


def read(prof) -> Optional[Trace]:
    """The Trace of a finished profiler, or None when it holds no device work."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    lo, hi = None, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in UTILITY_EVENTS or _flag(e, "is_hidden_event"):
            continue
        s, t = int(e.start_ns()), int(e.end_ns())
        lo, hi = (s if lo is None else min(lo, s)), (t if hi is None else max(hi, t))
        if e.device_type() == DeviceType.CUDA:
            if _flag(e, "is_user_annotation"):
                ranges[name].append((s, t))
            else:
                kernels.append((name, s, t))
        else:
            host.append((name, s, t, _flag(e, "is_user_annotation")))
    if not kernels:
        return None
    tr = Trace(kernels, dict(ranges), host, (lo, hi))
    tr.busy = merge([(s, t) for _, s, t in kernels])
    return tr


def merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    spans = sorted(spans)
    out = [list(spans[0])] if spans else []
    for s, t in spans[1:]:
        if s > out[-1][1]:
            out.append([s, t])
        else:
            out[-1][1] = max(out[-1][1], t)
    return [(s, t) for s, t in out]


def is_kernel(name: str) -> bool:
    """A compute kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def inside(tr: Trace, range_name: str) -> Tuple[float, float]:
    """(seconds of compute kernels inside the device spans of `range_name`,
    seconds of compute kernels outside them)."""
    spans = merge(tr.device_ranges.get(range_name, []))
    if not spans:
        return 0.0, sum(t - s for n, s, t in tr.kernels if is_kernel(n)) / 1e9
    starts = np.array([s for s, _ in spans])
    ends = np.array([t for _, t in spans])
    ins = outs = 0
    for name, s, t in tr.kernels:
        if not is_kernel(name):
            continue
        i = np.searchsorted(starts, s, side="right") - 1
        if i >= 0 and t <= ends[i]:
            ins += t - s
        else:
            outs += t - s
    return ins / 1e9, outs / 1e9


def device_ops(tr: Trace, top: int = 10) -> List[List]:
    """The device operations that took most time: [[name, seconds], ...]."""
    total: Dict[str, int] = defaultdict(int)
    for name, s, t in tr.kernels:
        total[name] += t - s
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], ns / 1e9] for name, ns in ranked]


def idle_gaps(tr: Trace, top: int = 10, examined: int = 400) -> List[List]:
    """The device's idle time by what the host was doing, longest first:
    each gap between busy spans (and at the window's ends) is named by the
    innermost benchmark range and the innermost host event that cover its
    middle; [[name, seconds], ...] summed by name. The `examined` longest
    gaps are named, the rest summed under "(shorter gaps)"."""
    lo, hi = tr.window_ns
    edges = [lo] + [x for span in tr.busy for x in span] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named, rest = gaps[:examined], gaps[examined:]
    h_start = np.array([s for _, s, _, _ in tr.host], dtype=np.int64)
    h_end = np.array([t for _, _, t, _ in tr.host], dtype=np.int64)
    is_range = np.array([r and n.startswith("portbench::") for n, _, _, r in tr.host], dtype=bool)
    total: Dict[str, int] = defaultdict(int)
    for s, t in named:
        mid = (s + t) // 2
        cover = (h_start <= mid) & (h_end >= mid)
        label = []
        for pick in (cover & is_range, cover & ~is_range):
            idx = np.nonzero(pick)[0]
            if idx.size:
                label.append(tr.host[idx[np.argmax(h_start[idx])]][0])
        total[" > ".join(label) or "(no host event)"] += t - s
    if rest:
        total["(shorter gaps)"] += sum(t - s for s, t in rest)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], ns / 1e9] for name, ns in ranked]

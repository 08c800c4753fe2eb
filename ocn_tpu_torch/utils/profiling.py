"""The card's own time, from ``torch.profiler``: a kernel's device time
apart from the Python wrapper that launches it, and where the device time
of a training step goes.

Kernels launched from the port's ctypes libraries appear in the trace
under their CUDA names (``window_rows_kernel``, ``membership_kernel``, ...),
like PyTorch's own.  ``chip_smoke.py`` reads these numbers; the CUDA events
it also takes time whole calls, wrapper included.
"""
from __future__ import annotations

import collections
import re
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

# (name, start µs, end µs) of one device activity: a kernel, memcpy or memset
Interval = Tuple[str, float, float]

# the record_function region profile_region times
REGION = "profiled_region"


def device_intervals(prof) -> List[Interval]:
    """Every device activity of a finished profile, in its time base.  The
    profiler's own annotations (a ``record_function`` region drawn on the
    device's timeline) are not activities and are left out."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name != REGION
            and not getattr(e, "is_user_annotation", False)]


def profile_calls(fn: Callable[[], object], iters: int) -> List[Interval]:
    """Device activities of ``iters`` calls of ``fn`` (the card must have
    finished earlier work)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_intervals(prof)


def kernel_device_ms(fn: Callable[[], object], pattern: str, iters: int = 50,
                     warmup: int = 5) -> Tuple[float, int]:
    """Mean device time in ms of the kernels whose name matches the regular
    expression ``pattern`` over ``iters`` calls of ``fn``, and how many the
    trace holds (the profiler can miss the first few).  Raises if none."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    hits = [(t1 - t0) for name, t0, t1 in profile_calls(fn, iters)
            if re.search(pattern, name)]
    if not hits:
        raise RuntimeError(f"the profiler lists no kernel matching {pattern!r}")
    return sum(hits) / len(hits) / 1e3, len(hits)


def busy_us(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Length of the union of the intervals, clipped to [lo, hi]."""
    spans = sorted((max(t0, lo), min(t1, hi)) for _, t0, t1 in intervals
                   if t1 > lo and t0 < hi)
    total, end = 0.0, lo
    for t0, t1 in spans:
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def top_kernels(intervals: Sequence[Interval], n: int = 10,
                width: int = 120) -> List[Dict[str, object]]:
    """The n names with the most device time: ms in all, launches, and the
    name cut to ``width`` characters."""
    ms: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.Counter()
    for name, t0, t1 in intervals:
        ms[name] += (t1 - t0) / 1e3
        count[name] += 1
    order = sorted(ms, key=ms.get, reverse=True)[:n]
    return [{"name": name[:width], "ms": ms[name], "launches": count[name]}
            for name in order]


def step_breakdown(intervals: Sequence[Interval], window: Tuple[float, float],
                   n: int = 10) -> Dict[str, object]:
    """Device-busy share of a host window (µs) and its top kernels."""
    lo, hi = window
    inside = [iv for iv in intervals if iv[2] > lo and iv[1] < hi]
    busy = busy_us(inside, lo, hi)
    return {"window_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (hi - lo) if hi > lo else None,
            "device_activities": len(inside), "top_kernels": top_kernels(inside, n)}


def profile_region(fn: Callable[[], object], cuda: bool = True
                   ) -> Tuple[object, Dict[str, object]]:
    """Run ``fn`` once under the profiler; returns its result and the
    breakdown of the device time inside it.  Without ``cuda`` (a CPU run)
    no device activity is traced and the breakdown has no device numbers."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(REGION):
            out = fn()
    span = [e.time_range for e in prof.events()
            if e.name == REGION and e.device_type == DeviceType.CPU]
    window = (span[0].start, span[0].end)
    if not cuda:
        return out, {"window_ms": (window[1] - window[0]) / 1e3,
                     "device_busy_share": None, "top_kernels": []}
    return out, step_breakdown(device_intervals(prof), window)

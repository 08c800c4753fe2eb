"""The card's own time: a kernel's device time apart from the Python
wrapper that launches it (CUDA events around calls queued behind a spin
kernel), and where the device time of a training step goes
(``torch.profiler``).

Kernels launched from the port's ctypes libraries appear in the profiler's
trace under their CUDA names (``window_rows_kernel``, ``membership_kernel``,
``seg_tiles``, ...), like PyTorch's own.  ``chip_smoke.py`` reads these numbers; the CUDA
events it also takes without a spin time whole calls, wrapper included.
``chrome_trace`` is the CLI's ``--profile_dir``: a region's trace as a
file, the counterpart of ``jax.profiler.trace``.
"""
from __future__ import annotations

import collections
import os
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


def queued_device_ms(fn: Callable[[], object], iters: int = 50, warmup: int = 5,
                     spin_cycles: int = 1 << 24) -> float:
    """The card's time in ms for one call of ``fn``, apart from the host's:
    ``iters`` calls queued behind a spin kernel, so that the card runs them
    back to back, timed by CUDA events around them.  The spin doubles until
    the host has queued every call before the card reaches the first.

    The trace of ``torch.profiler`` is no substitute here: in a long process
    it drops a growing share of a short window's kernels, every one of them
    in the end, so a number read from it is not there when it is asked for."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(8):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        spin_cycles *= 2
    raise RuntimeError(f"the host took longer to queue {iters} calls than "
                       f"{spin_cycles // 2} cycles of spin")


def kernel_names(fn: Callable[[], object], iters: int = 20) -> List[str]:
    """The names of the device activities of ``iters`` calls of ``fn`` that
    the profiler's trace holds (it can drop some; raises if it holds none)."""
    torch.cuda.synchronize()
    names = [name for name, _, _ in profile_calls(fn, iters)]
    if not names:
        raise RuntimeError("the profiler's trace holds no device activity")
    return names


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


# kernel classes a step's device time is split into (by a substring of the
# kernel's name): the port's sorted segment sum (csrc/segment_sum.cu), and
# PyTorch's index kernels (index_add_ and index_copy_ among them) and
# scatters, the atomic scatter-adds it replaced
KERNEL_CLASSES = {"segment_sum": ("seg_tiles", "seg_spans"),
                  "index_kernels": ("indexFunc",),
                  "scatter_kernels": ("scatter",)}


def class_ms(intervals: Sequence[Interval]) -> Dict[str, Dict[str, float]]:
    """Device ms and launches of each KERNEL_CLASSES class."""
    out = {}
    for cls, keys in KERNEL_CLASSES.items():
        hits = [(t1 - t0) / 1e3 for name, t0, t1 in intervals
                if any(k in name for k in keys)]
        out[cls] = {"ms": sum(hits), "launches": len(hits)}
    return out


def step_breakdown(intervals: Sequence[Interval], window: Tuple[float, float],
                   n: int = 10) -> Dict[str, object]:
    """Device-busy share of a host window (µs), its top kernels and the
    device time of each kernel class (class_ms)."""
    lo, hi = window
    inside = [iv for iv in intervals if iv[2] > lo and iv[1] < hi]
    busy = busy_us(inside, lo, hi)
    return {"window_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (hi - lo) if hi > lo else None,
            "device_activities": len(inside), "top_kernels": top_kernels(inside, n),
            "kernel_classes": class_ms(inside)}


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
                     "device_busy_share": None, "top_kernels": [],
                     "kernel_classes": {}}
    return out, step_breakdown(device_intervals(prof), window)


def chrome_trace(profile_dir: str, cuda: bool = True) -> profile:
    """A profiler over a region (host activity, and the card's with
    ``cuda``) whose Chrome trace is written to ``profile_dir/trace.json``
    when the region ends."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(profile_dir, exist_ok=True)

    def export(prof) -> None:
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    return profile(activities=acts, on_trace_ready=export)

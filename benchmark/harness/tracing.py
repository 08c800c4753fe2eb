"""What the profiler's trace of a window says: device-busy time, the device
operations that took most time, and the longest idle gaps with what the host
was doing in each (from a sampler of the host's Python stack).

``busy_us`` and ``top_kernels`` are frozen copies of
ocn_tpu_torch/utils/profiling.py (``busy_us``, ``top_kernels``), so that a
later change to the program cannot move this yardstick.
"""
from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Dict, List, Sequence, Tuple

# (name, start us, end us) of one activity
Interval = Tuple[str, float, float]


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


def top_kernels(intervals: Sequence[Interval], n: int = 10) -> List[List]:
    """[name, seconds] of the n names with the most device time."""
    us: Dict[str, float] = collections.defaultdict(float)
    for name, t0, t1 in intervals:
        us[name] += t1 - t0
    order = sorted(us, key=us.get, reverse=True)[:n]
    return [[name[:200], us[name] / 1e6] for name in order]


# frames of the program's files name what the host was doing
OWN_CODE = "ocn_tpu_torch" + os.sep


class HostSampler:
    """Samples the main thread's Python stack every ``period`` seconds from
    a thread of its own: (perf_counter, innermost frame of the program's
    own code, or the innermost frame).  The profiler on the card's machine
    records no Python frames, so the idle gaps are named from these."""

    def __init__(self, period: float = 0.002):
        self.period = period
        self.samples: List[Tuple[float, str]] = []
        self._ident = threading.main_thread().ident
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self._ident)
            label, inner = None, None
            while frame is not None:
                code = frame.f_code
                name = f"{os.path.basename(code.co_filename)}:{frame.f_lineno} {code.co_name}"
                inner = inner or name
                if OWN_CODE in code.co_filename:
                    label = name
                    break
                frame = frame.f_back
            self.samples.append((time.perf_counter(), label or inner or "?"))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def _label(samples: Sequence[Tuple[float, str]], t0: float, t1: float) -> str:
    """The most frequent sample in [t0, t1] (host clock, s), else the
    nearest one."""
    inside = collections.Counter(lab for t, lab in samples if t0 <= t <= t1)
    if inside:
        return inside.most_common(1)[0][0]
    if not samples:
        return "no host sample"
    mid = 0.5 * (t0 + t1)
    return min(samples, key=lambda s: abs(s[0] - mid))[1]


def idle_gaps(intervals: Sequence[Interval], samples: Sequence[Tuple[float, str]],
              lo: float, hi: float, offset_us: float, n: int = 10) -> List[List]:
    """[label, seconds] of the n longest stretches of [lo, hi] (the trace's
    time base, us) with no device activity, each named by what the host
    sampler saw in it; ``offset_us`` maps host-clock seconds into the
    trace's time base (t_trace = 1e6 * t_host + offset_us)."""
    spans = sorted((max(t0, lo), min(t1, hi)) for _, t0, t1 in intervals
                   if t1 > lo and t0 < hi)
    gaps, end = [], lo
    for t0, t1 in spans:
        if t0 > end:
            gaps.append((end, t0))
        end = max(end, t1)
    if hi > end:
        gaps.append((end, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[_label(samples, (g0 - offset_us) / 1e6, (g1 - offset_us) / 1e6)[:200],
             (g1 - g0) / 1e6] for g0, g1 in gaps[:n]]


def read_profile(prof, region: str) -> Dict:
    """Device activities and the traced window (the span of the host events
    named ``region``) of a finished profile."""
    from torch.autograd import DeviceType

    dev, win = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name != region:
                dev.append((e.name, tr.start, tr.end))
        elif e.name == region:
            win.append((tr.start, tr.end))
    lo = min(w[0] for w in win)
    hi = max(w[1] for w in win)
    inside = [iv for iv in dev if iv[2] > lo and iv[1] < hi]
    return {"device": inside, "window_us": (lo, hi),
            "busy_us": busy_us(inside, lo, hi)}


def count_named(intervals: Sequence[Interval], keys: Sequence[str]) -> int:
    return sum(1 for name, _, _ in intervals if any(k in name for k in keys))


def time_named_s(intervals: Sequence[Interval], keys: Sequence[str]) -> float:
    return sum(t1 - t0 for name, t0, t1 in intervals
               if any(k in name for k in keys)) / 1e6

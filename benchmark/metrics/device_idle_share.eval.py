"""Share of the traced window in which no operation ran on the device:
one minus the union of the profiler's device activities (kernels, copies,
fills) over the window, which spans the traced units from the start of the
first to the end of the last (each ends when the device has finished)."""
UNIT = "%"


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    lo, hi = t["window_us"]
    return 100.0 * (1.0 - t["busy_us"] / (hi - lo))

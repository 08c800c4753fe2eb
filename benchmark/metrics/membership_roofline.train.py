"""The membership kernel's share of its roofline in the training steps:
the least time the work of the traced steps' lookups needs on one H100
(3.35 TB/s of HBM, 67 TFLOP/s float32; NVIDIA's data sheet, SXM, 700 W)
over the profiler's device time of the kernels named in KERNELS.  Not
reported when the trace holds another number of those kernels than the
program's launch counter (ops/membership.py ``membership_counts.launches``)
says ran in the traced span: a trace that dropped kernels would read high.

The work (``step_bound_s``, frozen): each chunk of C links looks its K
candidates up in two lists of pad_deg2 entries (the destination's
neighbours, its A^2 row); a lookup of R rows reads the queries (4 B), the
ids and weights (8 B a list entry) and writes its counts (4 B) once, and
makes one compare and one add per (query, entry) pair.  K is k_small in
the dual-K split's narrow chunks, pad_deg in the rest."""
UNIT = "%"
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
KERNELS = ("membership_kernel",)


def lookup_bound_s(rows, kq, ks):
    nbytes = rows * (4 * kq + 8 * ks) + 4 * rows * kq
    return max(nbytes / PEAK_BYTES, 2 * rows * kq * ks / PEAK_OPS)


def step_bound_s(stats):
    c, k2 = stats["chunk"], stats["pad_deg2"]
    narrow = stats["narrow_chunks"]
    wide = stats["chunks"] - narrow
    return 2 * (narrow * lookup_bound_s(c, stats["k_small"], k2)
                + wide * lookup_bound_s(c, stats["pad_deg"], k2))


def read(ctx):
    from harness import tracing

    t = ctx["trace"]
    if t is None:
        return None
    n = tracing.count_named(t["device"], KERNELS)
    if n == 0 or n != ctx["counters"]["membership"]:
        return None
    steps = ctx["stats"]["steps_per_epoch"] * ctx["n_traced"]
    return 100.0 * step_bound_s(ctx["stats"]) * steps / tracing.time_named_s(t["device"], KERNELS)

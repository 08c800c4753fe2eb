"""The membership kernel's share of its roofline in the evaluates: the
least time the traced evaluates' lookups need on one H100 (3.35 TB/s, 67
TFLOP/s float32; NVIDIA's data sheet, SXM, 700 W) over the profiler's device
time of the kernels named in KERNELS.  Not reported when the trace holds
another number of those kernels than ``membership_counts.launches`` says
ran in the traced span.

The work (``evaluate_bound_s``, frozen): each split is scored in batches of
testbs links (the last one padded); each batch looks its K candidates up in
two lists of pad_deg2 entries, K = k_small for the batches the dual-K split
scores narrow and pad_deg for the rest; a lookup of R rows reads the
queries (4 B), ids and weights (8 B an entry), writes its counts (4 B) once
and makes one compare and one add per (query, entry) pair."""
import math

UNIT = "%"
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
KERNELS = ("membership_kernel",)


def lookup_bound_s(rows, kq, ks):
    nbytes = rows * (4 * kq + 8 * ks) + 4 * rows * kq
    return max(nbytes / PEAK_BYTES, 2 * rows * kq * ks / PEAK_OPS)


def evaluate_bound_s(stats):
    tb, k2 = stats["testbs"], stats["pad_deg2"]
    total = 0.0
    for sp in stats["eval_splits"].values():
        narrow = sp["narrow"] // tb
        wide = math.ceil((sp["links"] - sp["narrow"]) / tb)
        total += 2 * (narrow * lookup_bound_s(tb, stats["k_small"], k2)
                      + wide * lookup_bound_s(tb, stats["pad_deg"], k2))
    return total


def read(ctx):
    from harness import tracing

    t = ctx["trace"]
    if t is None:
        return None
    n = tracing.count_named(t["device"], KERNELS)
    if n == 0 or n != ctx["counters"]["membership"]:
        return None
    bound = evaluate_bound_s(ctx["stats"]) * ctx["n_traced"]
    return 100.0 * bound / tracing.time_named_s(t["device"], KERNELS)

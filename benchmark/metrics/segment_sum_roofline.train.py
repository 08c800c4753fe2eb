"""The segment-sum kernel's share of its roofline in the training steps:
the least time the traced steps' sums need on one H100 (3.35 TB/s, 67
TFLOP/s float32; NVIDIA's data sheet, SXM, 700 W) over the profiler's
device time of the kernels named in KERNELS (three a call).  Not reported
when the trace holds another number of calls (COUNTED, one a call) than the
program's counter (ops/segment_sum.py ``segment_sum_raw.launches``) says
ran in the traced span, or when that counter holds another number of calls
than ``step_sums`` counts: the work below would then not be the work that
was timed.

The work (``step_sums``, frozen): every sum a step launches, each reading
its input rows, indices, scales and offsets once and writing its (S, W)
float32 output once, one multiply-add per entry and column: the encoder's
sum aggregation and its transpose in the backward (N x H from nnz
entries, 4 B index and 4 B value each); per chunk of C links with K
candidates, the column sums of the predictor's value planes (C*K
segments) and the frame aggregation's backward into the N x H gradient of
the node states (C*K rows of H)."""
UNIT = "%"
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
KERNELS = ("seg_partition", "seg_narrow", "seg_wide", "seg_fixup")
COUNTED = ("seg_partition",)
# value planes whose column sums a chunk takes: cn5's one-hop and two-hop
# frames and their orthogonalised product; cn7's one basis plane
PLANES = {"cn5": 3, "cn7": 1}


def planes(model):
    pred = model["predictor"]
    if pred not in PLANES:
        raise ValueError(f"segment_sum_roofline counts the sums of cn5 and cn7 steps, "
                         f"not of {pred!r}: a cell of another predictor needs its own "
                         f"count")
    return PLANES[pred]


def sum_bound_s(rows_read, width, segments, entries, entry_bytes):
    nbytes = (4 * rows_read * width + 4 * segments * width + 8 * (segments + 1)
              + entries * entry_bytes)
    return max(nbytes / PEAK_BYTES, 2 * entries * width / PEAK_OPS)


def step_sums(stats, model):
    """Every sum of one step: (rows read, width, segments, entries, bytes an
    entry)."""
    n, h, nnz, c = stats["n"], stats["hidden"], stats["nnz"], stats["chunk"]
    p = planes(model)
    out = [(n, h, n, nnz, 8)] * 2
    narrow = stats["narrow_chunks"]
    for chunks, k in ((narrow, stats["k_small"]),
                      (stats["chunks"] - narrow, stats["pad_deg"])):
        m = c * k
        out += [(m, p, m, m, 8), (m, h, n, m, 8)] * chunks
    return out


def step_bound_s(stats, model):
    return sum(sum_bound_s(*s) for s in step_sums(stats, model))


def read(ctx):
    from harness import tracing

    t = ctx["trace"]
    if t is None:
        return None
    n = tracing.count_named(t["device"], COUNTED)
    steps = ctx["stats"]["steps_per_epoch"] * ctx["n_traced"]
    sums = step_sums(ctx["stats"], ctx["cfg"]["model"])
    if n == 0 or n != ctx["counters"]["segment_sum"] or n != len(sums) * steps:
        return None
    bound = sum(sum_bound_s(*s) for s in sums) * steps
    return 100.0 * bound / tracing.time_named_s(t["device"], KERNELS)

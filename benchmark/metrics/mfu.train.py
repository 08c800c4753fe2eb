"""Model FLOPs of the training steps over their wall time, as a share of
one H100's float32 peak without tensor cores, 67 TFLOP/s (NVIDIA's data
sheet, SXM, at its 700 W power limit; both configurations are float32 with
TF32 off).  Taken over the window's epochs that ran without the profiler.

The count (``step_flops``, frozen): a multiply-add is two FLOPs; the
forward counts the encoder's Linear (N x F x H) and its sum aggregation
(one multiply-add per adjacency entry and hidden unit), and for every link
of the step the two frame aggregations (K candidates x H each, K the
narrow width k_small for the dual-K split's narrow chunks, pad_deg for the
rest) and the MLPs' dense layers; the backward counts twice the forward;
nothing is counted for recomputation, compares, sums or elementwise work."""
UNIT = "%"
PEAK_FLOPS = 67e12


def dense_layers(model):
    """H x H layers a link passes, and whether a final H x 1 follows: the
    pair MLP (one with tailact), the two CN MLPs (three each), the head."""
    pair = 1 if model["tailact"] else 2
    head = 2 if model["twolayerlin"] else 1
    return pair + 3 + 3 + head


def step_flops(stats, model):
    h, f, n = stats["hidden"], stats["features"], stats["n"]
    c = stats["chunk"]
    narrow = stats["narrow_chunks"]
    wide = stats["chunks"] - narrow
    encoder = 2 * n * f * h + 2 * stats["nnz"] * h
    frames = 2 * 2 * h * c * (narrow * stats["k_small"] + wide * stats["pad_deg"])
    mlps = (2 * dense_layers(model) * h * h + 2 * h) * stats["chunks"] * c
    return 3 * (encoder + frames + mlps)


def read(ctx):
    if ctx["device"]["platform"] != "gpu":
        return None
    units = [u for u in ctx["units"] if not u["traced"]] or ctx["units"]
    seconds = sum(u["t1"] - u["t0"] for u in units)
    stats = ctx["stats"]
    flops = step_flops(stats, ctx["cfg"]["model"]) * stats["steps_per_epoch"] * len(units)
    return 100.0 * flops / seconds / PEAK_FLOPS

"""Model FLOPs of the evaluates over their wall time, as a share of one
H100's float32 peak without tensor cores, 67 TFLOP/s (NVIDIA's data sheet,
SXM, 700 W; float32 with TF32 off).  Taken over the window's evaluates that
ran without the profiler.

The count (``evaluate_flops``, frozen): a multiply-add is two FLOPs; two
encoder passes (train graph, train+valid graph: Linear N x F x H and one
multiply-add per adjacency entry and hidden unit), and for every scored
link (not the padding of a split's last batch) the two frame aggregations
(K x H each, K = k_small for the links the dual-K split scores narrow,
pad_deg for the rest) and the MLPs' dense layers; forward only."""
UNIT = "%"
PEAK_FLOPS = 67e12


def dense_layers(model):
    pair = 1 if model["tailact"] else 2
    head = 2 if model["twolayerlin"] else 1
    return pair + 3 + 3 + head


def evaluate_flops(stats, model):
    h, f, n = stats["hidden"], stats["features"], stats["n"]
    encoder = 2 * (2 * n * f * h) + 2 * (stats["nnz"] + stats["nnz_full"]) * h
    per_link = 2 * dense_layers(model) * h * h + 2 * h
    total = encoder
    for sp in stats["eval_splits"].values():
        narrow, links = sp["narrow"], sp["links"]
        total += links * per_link
        total += 2 * 2 * h * (narrow * stats["k_small"] + (links - narrow) * stats["pad_deg"])
    return total


def read(ctx):
    if ctx["device"]["platform"] != "gpu":
        return None
    units = [u for u in ctx["units"] if not u["traced"]] or ctx["units"]
    seconds = sum(u["t1"] - u["t0"] for u in units)
    flops = evaluate_flops(ctx["stats"], ctx["cfg"]["model"]) * len(units)
    return 100.0 * flops / seconds / PEAK_FLOPS

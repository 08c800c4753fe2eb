"""Warm-up, seconds: the train cells' epoch 1 (its first step eager, the
second captured as a CUDA graph, the rest replayed; kernels built or loaded
on first use), the eval cell's first evaluate."""
UNIT = "s"


def read(ctx):
    return ctx["spans"]["warm_s"]

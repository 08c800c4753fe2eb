"""PyTorch/CUDA port of ocn_tpu (OCN link prediction).

The JAX package ``ocn_tpu`` is the reference; this package mirrors its
layout (``config``, ``sparse/``, ``data/``, ``ops/``, ``nn/``, ``train/``,
``cli``) and imports nothing from it.  It covers the cn5 (OCN) training
step and Hits@K evaluation on the "gather" two-hop path, with ELL tables,
the dual-K split, the window table, grouped frames and bfloat16 features,
and the row-gather instrument (``scripts/bench_gather.py``).  Its TPU
kernels are hand-written CUDA kernels under ``csrc/`` (membership counts,
window gather, row and sorted-block gathers), launched when their tensors
are on the card.

Entry points (``train.loop.Trainer``, ``cli.run``,
``scripts.bench_gather.main``) default to ``device="cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions.
"""

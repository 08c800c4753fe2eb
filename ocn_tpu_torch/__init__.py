"""PyTorch/CUDA port of ocn_tpu (OCN link prediction).

The JAX package ``ocn_tpu`` is the reference; this package mirrors its
layout (``config``, ``sparse/``, ``data/``, ``ops/``, ``nn/``, ``train/``,
``cli``) and imports nothing from it.  It covers the training step and
Hits@K (or MRR) evaluation of every predictor: the frame-based cn1, cn5
"OCN", cn6 with its A^3 path, cn7 "OCNP", cn8, cn9, and the incomplete
family cn2/cn3/cn4 with its recursion; under either encoder stack and
either two-hop mode, with ELL tables, the dual-K split, the window table,
grouped and hoisted frames, bfloat16 features and cndeg caps; and the
row-gather instrument (``scripts/bench_gather.py``).  Its TPU kernels are hand-written CUDA
kernels under ``csrc/`` (membership counts, window gather, row and
sorted-block gathers), launched when their tensors are on the card.

Entry points (``train.loop.Trainer``, ``cli.run``,
``scripts.bench_gather.main``) default to ``device="cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions.
"""

"""citation2-shape MRR eval throughput (port of scripts/bench_mrr.py): the
reference's 1,000 negatives a source through Trainer.evaluate_mrr on one
card.

    python -m ocn_tpu_torch.scripts.bench_mrr                        # the CUDA device
    OCN_BENCH_PLATFORM=cpu python -m ocn_tpu_torch.scripts.bench_mrr  # the CPU

The whole split at citation2 scale is about 3e8 scored links, so each of the
valid and test splits keeps its first OCN_BENCH_MRR_CAP sources (8192), and
the line gives scored links a second, the quantity that scales to the whole
eval.  Knobs, as in the JAX script: OCN_BENCH_SCALE (graph scale, 0.25),
OCN_BENCH_MRR_CAP, OCN_BENCH_TESTBS (65536), OCN_BENCH_ADJ2CAP (128).  The
negatives are drawn from ``default_rng(1)``, valid first, then test; the
ELL tables, where the stand-in's A^2 packs, from a second
``default_rng(1)``.  One warm evaluate_mrr, then one timed.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ocn_tpu_torch.scripts.bench import _sync, bench_device
# the Trainer, its seed-0 state and the ELL tables from default_rng(1), as
# the eval instrument builds them
from ocn_tpu_torch.scripts.bench_eval import setup

NUM_NEG = 1000  # the reference's negatives a source


def mrr_knobs():
    """(scale, cap, testbs, adj2_cap) from the OCN_BENCH_* knobs."""
    env = os.environ.get
    return (float(env("OCN_BENCH_SCALE", "0.25")),
            int(env("OCN_BENCH_MRR_CAP", "8192")),
            int(env("OCN_BENCH_TESTBS", "65536")),
            int(env("OCN_BENCH_ADJ2CAP", "128")))


def mrr_config(testbs: int, adj2_cap: int):
    """The JAX script's Config: bench.py's citation2 shape (the "ho" stack,
    puregcn x 3 at hidden 64, path-count cn2, randint-target negatives) in
    bfloat16."""
    from ocn_tpu_torch.config import Config

    return Config(
        dataset="citation2", predictor="cn5", model="puregcn", mplayers=3,
        hiddim=64, encoder_stack="ho", cn2_counts=True,
        neg_mode="randint_target", batch_size=32768, linkbatchsize=2048,
        testbs=testbs, maskinput=True, dtype="bfloat16", k_small=16,
        adj2_cap=adj2_cap,
    )


def mrr_dataset(scale: float, cap: int):
    """Synthetic citation2 (seed 0) at ``scale``, BFS-relabelled, its valid
    and test splits cut to their first ``cap`` sources, each with NUM_NEG
    negatives from ``default_rng(1)``; returns (dataset, scored links)."""
    from ocn_tpu_torch.data.loaders import synthetic_dataset

    ds = synthetic_dataset("citation2", seed=0, scale=scale).reorder_bfs()
    rng = np.random.default_rng(1)
    n_scored = 0
    for part in ("valid", "test"):
        sp = ds.split_edge[part]
        m = min(cap, sp["source_node"].shape[0])
        sp["source_node"] = sp["source_node"][:m]
        sp["target_node"] = sp["target_node"][:m]
        sp["target_node_neg"] = rng.integers(
            0, ds.n_nodes, size=(m, NUM_NEG)).astype(np.int64)
        n_scored += m * (NUM_NEG + 1)
    return ds, n_scored


def run(tr, state):
    """A warm evaluate_mrr, then a timed one; returns (seconds, MRR)."""
    tr.evaluate_mrr(state)  # warm
    _sync(tr.device)
    t0 = time.perf_counter()
    out = tr.evaluate_mrr(state)
    _sync(tr.device)
    return time.perf_counter() - t0, out


def mrr_line(scale: float, n_nodes: int, n_scored: int, dt: float, out) -> str:
    """The JAX script's line."""
    return (f"evaluate_mrr (scale {scale}, N={n_nodes:,}, "
            f"{n_scored:,} scored links incl. 1000 negs/src): {dt:.2f} s "
            f"-> {n_scored / dt:,.0f} links/s; MRR {out}")


def main() -> dict:
    """The program; prints its line and returns its numbers."""
    scale, cap, testbs, adj2_cap = mrr_knobs()
    ds, n_scored = mrr_dataset(scale, cap)
    tr, state = setup(mrr_config(testbs, adj2_cap), ds, bench_device())
    dt, out = run(tr, state)
    print(mrr_line(scale, ds.n_nodes, n_scored, dt, out), flush=True)
    return {"seconds": dt, "n_scored": n_scored, "mrr": out,
            "ell": bool(tr._use_ell)}


if __name__ == "__main__":
    main()

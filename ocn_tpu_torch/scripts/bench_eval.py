"""Eval-path throughput at the bench scale (port of scripts/bench_eval.py):
one Trainer.evaluate over every eval split of the collab stand-in
(synthetic collab at scale 1.0, BFS-relabelled) on one card, in the three
arms of the eval levers, set on the live Trainer in turn:

    ell=1 dualK=1   ELL tables at eval and the dual-K split of each split
    ell=1 dualK=0   ELL tables only
    ell=0 dualK=0   neither

    python -m ocn_tpu_torch.scripts.bench_eval                        # the CUDA device
    OCN_BENCH_PLATFORM=cpu python -m ocn_tpu_torch.scripts.bench_eval  # the CPU

Knobs, as in the JAX script: OCN_BENCH_BATCH (batch and testbs, 65536),
OCN_BENCH_PREDICTOR (cn5), OCN_BENCH_RECK (0).  The ELL tables are built
once, from ``default_rng(1)``.  Each arm runs one warm evaluate and one
timed one, and prints its seconds, the scored edges a second and Hits@50
(train, valid, test).  ``evaluate`` returns host values, so the clock stops
after the card is done.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ocn_tpu_torch.scripts.bench import _sync, bench_device

# (label, ell_eval, dual_k_eval), in the JAX script's order
ARMS = (
    ("ell=1 dualK=1", True, True),
    ("ell=1 dualK=0", True, False),
    ("ell=0 dualK=0", False, False),
)


def eval_config():
    """The JAX script's Config (bench.py's collab program, eval at testbs =
    batch) from the OCN_BENCH_* knobs."""
    from ocn_tpu_torch.config import Config

    batch = int(os.environ.get("OCN_BENCH_BATCH", "65536"))
    return Config(
        dataset="collab", predictor=os.environ.get("OCN_BENCH_PREDICTOR", "cn5"),
        model="gcn", mplayers=3, hiddim=256, batch_size=batch, testbs=batch,
        maskinput=True, ln=True, res=True, jk=True, use_xlin=True,
        tailact=True, pad_deg=64, pad_deg2=64, linkbatchsize=4096,
        frame_group=8, k_small=16, dtype="bfloat16",
        rec_k=int(os.environ.get("OCN_BENCH_RECK", "0")),
    )


def eval_dataset(scale: float = 1.0):
    """Synthetic collab (seed 0) at ``scale``, BFS-relabelled; the JAX
    script's is scale 1.0."""
    from ocn_tpu_torch.data.loaders import synthetic_dataset

    return synthetic_dataset("collab", seed=0, scale=scale).reorder_bfs()


def n_eval(ds) -> int:
    """The edges one evaluate scores, as the JAX script counts them: the
    test and valid positives and negatives, and the train positives."""
    se = ds.split_edge
    return sum(se[part][k].shape[0] for part in ("test", "valid")
               for k in ("edge", "edge_neg") if k in se[part]) + se["train"]["edge"].shape[0]


def setup(cfg, ds, device="cuda"):
    """The Trainer and its state from seed 0, the ELL tables built once from
    ``default_rng(1)`` where they are on."""
    from ocn_tpu_torch.train.loop import Trainer

    tr = Trainer(cfg, ds, device=device)
    state = tr.init_state(0)
    if tr._use_ell:
        tr._refresh_ell(np.random.default_rng(1))
    return tr, state


def run_arm(tr, state, ell_eval: bool, dual_k_eval: bool):
    """One arm on the live Trainer: its flags set, a warm evaluate, then a
    timed one; returns (seconds, results)."""
    tr.cfg.ell_eval = ell_eval
    tr.cfg.dual_k_eval = dual_k_eval
    tr.evaluate(state)  # warm
    _sync(tr.device)
    t0 = time.perf_counter()
    res = tr.evaluate(state)
    _sync(tr.device)
    return time.perf_counter() - t0, res


def arm_line(label: str, dt: float, n: int, res) -> str:
    """The JAX script's line of one arm."""
    return (f"evaluate() {label}: {dt:.2f} s for ~{n} scored edges "
            f"-> {n / dt:,.0f} edges/s (Hits@50: {res['Hits@50']})")


def main() -> list:
    """The three arms at the script's scale; prints a line an arm and
    returns [(label, seconds, results), ...]."""
    ds = eval_dataset()
    tr, state = setup(eval_config(), ds, bench_device())
    n = n_eval(ds)
    out = []
    for label, ell, dual in ARMS:
        dt, res = run_arm(tr, state, ell, dual)
        print(arm_line(label, dt, n, res), flush=True)
        out.append((label, dt, res))
    return out


if __name__ == "__main__":
    main()

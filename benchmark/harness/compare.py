"""The numbers that decide ``correct``: what a run produced against what the
plain reference produced from the same inputs.

Training (the first steps of epoch 1): each step's loss, the first step's
gradient of each parameter (leaf), and each leaf's change over the steps.
A leaf's gap is the gap between the program's norm and the reference's,
measured against the reference's norm of that leaf or of the median leaf,
whichever is larger.  A leaf whose reference gradient is under a thousandth
of the median leaf's moves by round-off alone under Adam and is left out of
the change.  Which of the numbers a cell holds, and at what limit, is in its
workload file (PERF.md §6 gives the readings): the later steps' losses and
the worst leaf's change swing from seed to seed (Adam turns round-off in
near-nought gradients into steps of up to the learning rate), so the cells
hold the first step's loss, the worst and the median leaf's gradient, and
the median leaf's change.  A ReLU input that lies within round-off of 0
falls on either side of it in float32, so on a few seeds one link's
gradient differs between two sound float32 runs; that shows most in the
worst leaf's gradient and, once Adam has stepped on it, in the median
leaf's change, and their limits leave room for it.

Training, the window's epochs: what the program derived for its last
epoch, as the step it drove last was given it (the last batch's links in
the dual-K order, their inverse orders and mask positions, the seed of the
step's draws) and the window tables the step reads, against the
reference's own derivation from the seed; each number counts the entries
that differ, and its limit is 0.

Evaluation: every score of every split, the widest gap measured against the
reference score or the median absolute reference score, whichever is
larger.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

NOUGHT = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    names = list(names)
    if not names:
        return {}
    med = float(np.median([ref[k] for k in names]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def _median(d: Dict[str, float]) -> float:
    return float(np.median(list(d.values()))) if d else 0.0


def train_readings(prog: Dict, ref: Dict) -> Tuple[Dict[str, float], Dict]:
    """(numbers, detail) of prog against ref, each {"losses": [..],
    "grads1": {leaf: tensor}, "p0": {leaf: tensor}, "p_last": {leaf:
    tensor}}; the detail (each step's loss gap, the worst leaves, the leaves
    left out) is for the log."""
    missing = set(ref["grads1"]) ^ set(prog["grads1"])
    if missing:
        raise KeyError(f"leaves on one side only: {sorted(missing)}")
    lp, lr = np.asarray(prog["losses"], float), np.asarray(ref["losses"], float)
    loss = np.abs(lp - lr) / np.abs(lr)
    g_p, g_r = _norms(prog["grads1"]), _norms(ref["grads1"])
    med_g = float(np.median(list(g_r.values())))
    moved = [k for k, v in g_r.items() if v >= NOUGHT * med_g]
    d_p = _norms({k: prog["p_last"][k].cpu() - prog["p0"][k].cpu() for k in ref["p0"]})
    d_r = _norms({k: ref["p_last"][k].cpu() - ref["p0"][k].cpu() for k in ref["p0"]})
    grad, step = _gaps(g_p, g_r, g_r), _gaps(d_p, d_r, moved)
    init = max(float((prog["p0"][k].cpu() - ref["p0"][k].cpu()).abs().max())
               for k in ref["p0"])
    numbers = {"loss_gap": float(loss.max()), "loss1_gap": float(loss[0]),
               "grad_gap": max(grad.values(), default=0.0), "grad_median_gap": _median(grad),
               "step_gap": max(step.values(), default=0.0), "step_median_gap": _median(step),
               "init_gap": init}
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]  # noqa: E731
    detail = {"loss_gaps": loss.tolist(), "grad_worst": worst(grad),
              "step_worst": worst(step), "left_out": sorted(set(g_r) - set(moved))}
    return numbers, detail


def eval_numbers(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> float:
    """The widest score gap over every split."""
    allr = np.concatenate([np.asarray(ref[k], np.float64) for k in ref])
    med = float(np.median(np.abs(allr)))
    out = 0.0
    for k in ref:
        r = np.asarray(ref[k], np.float64)
        p = np.asarray(prog[k], np.float64)
        if p.shape != r.shape:
            return float("inf")
        gap = np.abs(p - r) / np.maximum(np.abs(r), med)
        out = max(out, float(np.max(gap)) if gap.size else 0.0)
    return out


def _unequal(a, b) -> int:
    """Entries of ``a`` unlike ``b``'s; every entry where the shapes differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int(np.count_nonzero(a.astype(np.int64) != b.astype(np.int64)))


def _unequal_lanes(tbl, ref: np.ndarray) -> int:
    """Window entries of a table unlike the reference's (-1 there: a lane
    past the row's degree, which holds none of its entries)."""
    tbl = np.asarray(tbl)
    if tbl.shape != ref.shape:
        return max(ref.size, 1)
    ok = ref >= 0
    return int(np.count_nonzero(tbl.astype(np.int64)[ok] != ref[ok]))


def epoch_numbers(prog: Dict, ref: Dict) -> Dict[str, int]:
    """The last epoch's inputs of the program (``prog``: the step's last
    arguments, ``tables`` a list of the window tables the step reads) that
    differ from the reference's ``last_epoch``."""
    rt = ref["tables"]
    ell = 0
    for t in prog["tables"] or [{}]:
        for k, r in rt.items():
            if k not in t:
                ell += r.size
            else:
                ell += (_unequal_lanes if k.startswith("ell") else _unequal)(t[k], r)
    return {"batch_unequal": _unequal(prog["pos"], ref["pos"])
            + _unequal(prog["inv_p"], ref["inv_p"]) + _unequal(prog["mask"], ref["mask"]),
            "neg_unequal": _unequal(prog["neg"], ref["neg"])
            + _unequal(prog["inv_n"], ref["inv_n"]),
            "ell_unequal": ell,
            "seed_unequal": int(prog["seed"] != ref["seed"])}

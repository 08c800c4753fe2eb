"""Hyperparameter search (port of ocn_tpu/train/hpo.py): random search
over the knobs the reference README's commands vary (learning rates, the
dropout family, alpha), with the port's CLI engine
(`ocn_tpu_torch.cli.run`, multi-run best-by-validation) as the trial
objective.  Pure NumPy apart from that objective.

Usage:
    python -m ocn_tpu_torch.train.hpo --dataset Cora --predictor cn5 \
        --preset --trials 16 --epochs 20

Each trial appends one JSON line to `<out>/hpo_<dataset>_<predictor>.jsonl`
(sampled overrides + val/test mean±std) and the winner is printed and
returned; searches are reproducible from `--hpo_seed`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ocn_tpu_torch.config import Config


# (sampler kind, spec). "log": loguniform(lo, hi); "choice": uniform over
# the listed values.  Mirrors the reference README's per-dataset tuning axes
# (README.md:27-98: gnnlr/prelr, gnndp/predp/xdp/tdp/gnnedp/preedp, alpha).
DEFAULT_SPACE: Dict[str, Tuple[str, Any]] = {
    "gnnlr": ("log", (1e-4, 3e-2)),
    "prelr": ("log", (1e-4, 3e-2)),
    "gnndp": ("choice", (0.0, 0.05, 0.1, 0.25, 0.5)),
    "predp": ("choice", (0.0, 0.05, 0.1, 0.25, 0.5)),
    "xdp": ("choice", (0.0, 0.25, 0.5, 0.7)),
    "tdp": ("choice", (0.0, 0.05, 0.25)),
    "gnnedp": ("choice", (0.0, 0.25)),
    "preedp": ("choice", (0.0, 0.25)),
    "alpha": ("choice", (0.5, 1.0, 2.0)),
}


def sample(space: Dict[str, Tuple[str, Any]],
           rng: np.random.Generator) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, (kind, spec) in space.items():
        if kind == "log":
            lo, hi = spec
            out[name] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        elif kind == "choice":
            out[name] = spec[int(rng.integers(len(spec)))]
        elif kind == "uniform":
            lo, hi = spec
            out[name] = float(rng.uniform(lo, hi))
        else:
            raise ValueError(f"unknown sampler kind {kind!r} for {name}")
    return out


def random_search(
    base: Config,
    trials: int,
    space: Optional[Dict[str, Tuple[str, Any]]] = None,
    seed: int = 0,
    out_dir: str = "rec",
    objective: Optional[Callable[[Config], dict]] = None,
) -> dict:
    """Random search; returns the best trial record (max val_mean).

    ``objective(cfg) -> {"val_mean", "val_std", "tst_mean", "tst_std"}``
    defaults to the CLI engine (full multi-run training + eval).
    """
    if objective is None:
        from ocn_tpu_torch.cli import run as objective  # type: ignore[assignment]
    space = DEFAULT_SPACE if space is None else space
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"hpo_{base.dataset}_{base.predictor}.jsonl")
    best: Optional[dict] = None
    for t in range(trials):
        overrides = sample(space, rng)
        cfg = dataclasses.replace(base, **overrides)
        # per-trial isolation: an aggressive lr/dropout sample may diverge
        # (NaN loss) or OOM — log the failure and keep searching instead of
        # aborting the whole run
        try:
            res = objective(cfg)
        except Exception as e:  # noqa: BLE001 — any trial failure is loggable
            rec = {"trial": t, "overrides": overrides,
                   "error": f"{type(e).__name__}: {e}"}
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[hpo] trial {t}: FAILED ({rec['error']})", flush=True)
            continue
        rec = {"trial": t, "overrides": overrides, **res}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        # non-finite val (diverged run) must never become the incumbent
        if np.isfinite(res["val_mean"]) and (
                best is None or rec["val_mean"] > best["val_mean"]):
            best = rec
        best_s = f"{best['val_mean']:.4f}" if best is not None else "n/a"
        print(f"[hpo] trial {t}: val {res['val_mean']:.4f} "
              f"tst {res['tst_mean']:.4f}  best val {best_s}",
              flush=True)
    assert best is not None, "every trial failed or returned non-finite val"
    print(f"[hpo] best: {json.dumps(best)}", flush=True)
    return best


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    from ocn_tpu_torch.cli import parseargs

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trials", type=int, default=16)
    p.add_argument("--hpo_seed", type=int, default=0)
    p.add_argument("--hpo_out", type=str, default="rec")
    p.add_argument("--space", type=str, default=None,
                   help="JSON dict overriding DEFAULT_SPACE, e.g. "
                        '\'{"gnnlr": ["log", [1e-4, 1e-2]]}\'')
    args, rest = p.parse_known_args(argv)
    base = parseargs(rest)
    space = None
    if args.space:
        space = {k: (kind, tuple(spec) if isinstance(spec, list) else spec)
                 for k, (kind, spec) in json.loads(args.space).items()}
    return random_search(base, args.trials, space=space, seed=args.hpo_seed,
                         out_dir=args.hpo_out)


if __name__ == "__main__":
    main()

"""Command line of the PyTorch port (port of ocn_tpu/cli.py): the same flag
surface (every Config field), presets, multi-run training with
best-by-validation tracking.

    python -m ocn_tpu_torch.cli --dataset collab --predictor cn5 --preset \\
        --epochs 3

runs on the CUDA device; ``--platform cpu`` runs on the CPU.  Boolean flags
take an optional value (``--ln``, ``--ln true``, ``--ln false``) or the
``--no-`` form.  citation2 is scored by MRR (Trainer.evaluate_mrr), every
other dataset by Hits@K.  Fields the port does not implement yet raise
NotImplementedError naming the field (Config.require_supported); so do the
checkpoint, embedding-export and profiling flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from ocn_tpu_torch.config import Config, presets
from ocn_tpu_torch.data.loaders import loaddataset
from ocn_tpu_torch.nn.conv import CONV_NAMES
from ocn_tpu_torch.nn.predictors import PREDICTOR_NAMES
from ocn_tpu_torch.train.loop import Trainer
from ocn_tpu_torch.train.losses import LOSSES


def _bool(text: str) -> bool:
    low = text.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def parseargs(argv=None) -> Config:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", action="store_true",
                   help="start from the README preset for (dataset, predictor)")
    defaults = Config()
    for f in dataclasses.fields(Config):
        name = f.name
        if isinstance(f.default, bool):
            p.add_argument(f"--{name}", nargs="?", const=True, type=_bool, default=None)
            p.add_argument(f"--no-{name}", dest=name, action="store_false")
        elif name == "model":
            p.add_argument("--model", choices=CONV_NAMES, default=None)
        elif name == "predictor":
            p.add_argument("--predictor", choices=PREDICTOR_NAMES, default=None)
        elif name == "losstrick":
            p.add_argument("--losstrick", choices=sorted(LOSSES), default=None)
        else:
            typ = type(f.default) if f.default is not None else str
            p.add_argument(f"--{name}", type=typ, default=None)
    args = p.parse_args(argv)
    overrides = {
        k: v for k, v in vars(args).items() if k != "preset" and v is not None
    }
    if args.preset:
        return presets(
            overrides.pop("dataset", defaults.dataset),
            overrides.pop("predictor", "cn5"),
            **overrides,
        )
    base = dataclasses.asdict(defaults)
    base.update(overrides)
    return Config(**base)


HEADLINE = {  # best-by-validation headline metric per dataset
    "collab": "Hits@50", "ppa": "Hits@100", "ddi": "Hits@20",
    "Cora": "Hits@100", "Citeseer": "Hits@100", "Pubmed": "Hits@100",
    "citation2": "MRR",
}


def run(cfg: Config, device: str = "cuda") -> dict:
    """Multi-run training with best-by-validation tracking (reference
    main()).  ``cfg.platform == "cpu"`` also selects the CPU."""
    for field in ("savemod", "loadmod", "save_gemb", "savex"):
        if getattr(cfg, field):
            raise NotImplementedError(
                f"Config.{field}: checkpoints and embedding export are not "
                "ported to ocn_tpu_torch yet (ROADMAP.md)")
    if cfg.profile_dir:
        raise NotImplementedError("Config.profile_dir is not ported yet")
    if cfg.platform == "cpu":
        device = "cpu"
    planetoid = cfg.dataset in ("Cora", "Citeseer", "Pubmed")
    headline = HEADLINE.get(cfg.dataset, "Hits@100")
    mrr_mode = cfg.dataset == "citation2"
    ret = []
    ds = None
    for run_i in range(cfg.runs):
        if ds is None or planetoid:  # fresh random split per Planetoid run
            ds = loaddataset(cfg.dataset, cfg.use_valedges_as_input, cfg.load,
                             root=cfg.data_root, seed=cfg.seed + run_i,
                             synthetic_scale=cfg.synthetic_scale)
            if cfg.reorder == "bfs":
                ds = ds.reorder_bfs()
        tr = Trainer(cfg, ds, device=device)
        state = tr.init_state(cfg.seed + run_i)
        rng = np.random.default_rng(cfg.seed + run_i)
        best = None
        for epoch in range(1, cfg.epochs + 1):
            t1 = time.time()
            state, loss = tr.train_epoch(state, rng, epoch)
            ttrain = time.time() - t1
            t1 = time.time()
            if mrr_mode:
                res = tr.evaluate_mrr(state)
                results = {"MRR": (res["valid"], res["valid"], res["test"])}
            else:
                results = tr.evaluate(state)
            ttest = time.time() - t1
            print(f"trn time {ttrain:.2f} s  test time {ttest:.2f} s", flush=True)
            if best is None:
                best = {k: list(v) for k, v in results.items()}
            for key, (trn, val, tst) in results.items():
                if val > best[key][1]:
                    best[key] = [trn, val, tst]
                print(
                    f"{key}  Run: {run_i + 1:02d}, Epoch: {epoch:02d}, "
                    f"Loss: {loss:.4f}, Train: {100 * trn:.2f}%, "
                    f"Valid: {100 * val:.2f}%, Test: {100 * tst:.2f}%",
                    flush=True,
                )
        print(f"best {best}")
        ret.append(best[headline][-2:])
    ret = np.array(ret)
    summary = {
        "val_mean": float(ret[:, 0].mean()), "val_std": float(ret[:, 0].std()),
        "tst_mean": float(ret[:, 1].mean()), "tst_std": float(ret[:, 1].std()),
        "headline": headline,
    }
    print(
        f"Final result: val {summary['val_mean']:.4f} {summary['val_std']:.4f} "
        f"tst {summary['tst_mean']:.4f} {summary['tst_std']:.4f}"
    )
    return summary


def main(argv=None):
    cfg = parseargs(argv)
    print(cfg, flush=True)
    return run(cfg)


if __name__ == "__main__":
    main()

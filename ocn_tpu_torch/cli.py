"""Command line of the PyTorch port (port of ocn_tpu/cli.py): the same flag
surface (every Config field), presets, multi-run training with
best-by-validation tracking.

    python -m ocn_tpu_torch.cli --dataset collab --predictor cn5 --preset \\
        --epochs 3

runs on the CUDA device; ``--platform cpu`` runs on the CPU.  Boolean flags
take an optional value (``--ln``, ``--ln true``, ``--ln false``) or the
``--no-`` form.  citation2 is scored by MRR (Trainer.evaluate_mrr), every
other dataset by Hits@K.  Per-epoch results go to a MetricLogger in
``rec/{model}_{predictor}``.  ``--savemod`` with ``--checkpoint_dir`` saves
the whole train state at each new best validation, ``--loadmod`` resumes
from the latest one; ``--save_gemb`` and ``--savex`` write the best state's
hidden states and Embedding table under ``gemb/``; ``--profile_dir`` traces
epoch 1 of run 0 with torch.profiler into a Chrome trace there.

``--dp_devices``/``--tp_devices`` above 1 run the program on dp x tp ranks
(parallel/launch.py: one process each, on the card or, with ``--platform
cpu``, on the CPU over gloo); ``--graph_sharding node`` shards the graph
over the dp ranks.  Rank 0 alone prints, logs and writes files.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import time

import numpy as np

from ocn_tpu_torch.config import Config, presets
from ocn_tpu_torch.data.loaders import loaddataset
from ocn_tpu_torch.nn.conv import CONV_NAMES
from ocn_tpu_torch.nn.predictors import PREDICTOR_NAMES
from ocn_tpu_torch.train.loop import Trainer
from ocn_tpu_torch.train.losses import LOSSES
from ocn_tpu_torch.utils.logging import MetricLogger
from ocn_tpu_torch.utils.profiling import chrome_trace


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


def run_dataset(cfg: Config, run_i: int = 0):
    """The dataset of run ``run_i``: seeded by seed + run_i (each Planetoid
    run draws a fresh random split), BFS-relabelled when cfg.reorder says."""
    ds = loaddataset(cfg.dataset, cfg.use_valedges_as_input, cfg.load,
                     root=cfg.data_root, seed=cfg.seed + run_i,
                     synthetic_scale=cfg.synthetic_scale)
    return ds.reorder_bfs() if cfg.reorder == "bfs" else ds


class _Silent:
    """The MetricLogger of the ranks other than 0: they log nothing."""

    def text(self, *args):
        pass

    def scalars(self, *args):
        pass

    def close(self):
        pass


def _rank_run(info, cfg: Config) -> dict:
    return run(cfg, device=str(info.device))


def run(cfg: Config, device: str = "cuda") -> dict:
    """Multi-run training with best-by-validation tracking (reference
    main()).  ``cfg.platform == "cpu"`` also selects the CPU.  With
    dp_devices * tp_devices > 1 it launches that many ranks, each running
    this function, and returns rank 0's summary."""
    import torch.distributed as dist

    from ocn_tpu_torch.parallel.launch import launch

    if cfg.platform == "cpu":
        device = "cpu"
    nranks = cfg.dp_devices * cfg.tp_devices
    if nranks > 1 and not dist.is_initialized():
        return launch(_rank_run, nranks, cfg, device=device)[0]
    lead = not dist.is_initialized() or dist.get_rank() == 0
    logger = MetricLogger(f"rec/{cfg.model}_{cfg.predictor}") if lead else _Silent()
    try:
        logger.text("hyperparams", json.dumps(dataclasses.asdict(cfg)))
        with (contextlib.nullcontext() if lead
              else contextlib.redirect_stdout(io.StringIO())):
            return _run(cfg, device, logger, lead)
    finally:
        logger.close()


def _run(cfg: Config, device: str, logger: MetricLogger, lead: bool = True) -> dict:
    planetoid = cfg.dataset in ("Cora", "Citeseer", "Pubmed")
    headline = HEADLINE.get(cfg.dataset, "Hits@100")
    mrr_mode = cfg.dataset == "citation2"
    gemb = f"gemb/{cfg.dataset}_{cfg.model}_{cfg.predictor}_{cfg.hiddim}"
    ret = []
    ds = None
    for run_i in range(cfg.runs):
        if ds is None or planetoid:  # fresh random split per Planetoid run
            ds = run_dataset(cfg, run_i)
        tr = Trainer(cfg, ds, device=device)
        state = tr.init_state(cfg.seed + run_i)
        if cfg.loadmod and cfg.checkpoint_dir:
            # the whole train state: parameters, EMA, sched and Adam
            from ocn_tpu_torch.train.checkpoint import load_state
            state, step0 = load_state(cfg.checkpoint_dir, state)
            print(f"resumed from {cfg.checkpoint_dir} step {step0}", flush=True)
        rng = np.random.default_rng(cfg.seed + run_i)
        best = None
        for epoch in range(1, cfg.epochs + 1):
            t1 = time.time()
            profiling = cfg.profile_dir and epoch == 1 and run_i == 0 and lead
            with (chrome_trace(cfg.profile_dir, tr.device.type == "cuda")
                  if profiling else contextlib.nullcontext()):
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
                logger.scalars(f"{key}_{run_i}",
                               {"trn": trn, "val": val, "tst": tst}, epoch)
                if val > best[key][1]:
                    best[key] = [trn, val, tst]
                    # best-by-validation saves (reference
                    # NeighborOverlap_large.py:334-340)
                    if cfg.savemod and cfg.checkpoint_dir and lead:
                        from ocn_tpu_torch.train.checkpoint import save_state
                        save_state(cfg.checkpoint_dir, state, epoch)
                    if cfg.save_gemb:
                        from ocn_tpu_torch.train.checkpoint import save_embeddings
                        h = tr.encode(state)  # every rank: sharded, collective
                        if lead:
                            save_embeddings(f"{gemb}.npy", h)
                    if cfg.savex and state.encoder.emb is not None and lead:
                        from ocn_tpu_torch.train.checkpoint import save_embeddings
                        save_embeddings(f"{gemb}_{run_i}.npy",
                                        state.encoder.emb.weight)
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

"""Accuracy instrument: train to convergence, arm by arm (port of
scripts/accuracy_parity.py).

    python -m ocn_tpu_torch.scripts.accuracy_parity --graph sbm \
        --predictor cn5 --variants capped_ell --epochs 24 --runs 3 \
        --out results/parity_torch_h100.jsonl
    python -m ocn_tpu_torch.scripts.accuracy_parity --table \
        --out results/parity_torch_h100.jsonl \
        --against results/parity_jax_head.jsonl

An arm is one (graph, predictor, variant): the graph's config (a README
preset for Cora, Citeseer and Pubmed, the ppa preset at a CPU-trainable
batch, or the sbm learnability proxy) with the variant's frame widths,
two-hop mode, A^2/A^3 caps and table knobs on top.  Each run trains from
seed ``run`` for ``--epochs`` epochs, evaluates every ``--eval_every`` epochs
and at the last, and keeps for each Hits@K the (train, valid, test) of its
best validation epoch.

Each (arm, run) appends one JSON line to ``--out`` with the JAX script's
fields, plus ``package``, the card's ``device`` and ``power_limit`` (as
nvidia-smi reports them), ``membership_launches`` (the membership kernel's
launches over the run) and the per-epoch ``losses``; pairs already in the
file are skipped, so an interrupted study resumes.  ``--table`` prints the
aggregate of ``--out``; with ``--against`` it also holds each arm present in
both files against the reference: n, mean and sd of best test Hits@50 on
each side, the difference, and a two-sided Welch p (Hits@20 and Hits@100
beside it).

Runs on the card (``--platform cuda``, the default; it raises without one)
or on the CPU with ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, Tuple

import numpy as np

from ocn_tpu_torch.config import Config, presets
from ocn_tpu_torch.data.loaders import LinkDataset, loaddataset
from ocn_tpu_torch.ops import membership as M
from ocn_tpu_torch.train.loop import Trainer, TrainState, resolve_device

# the Hits@K compared by --against, the first one decides
HITS = ("Hits@50", "Hits@20", "Hits@100")


def base_config(graph: str, epochs: int, predictor: str = "cn5") -> Config:
    """The graph's config before the variant's overrides."""
    if graph in ("Cora", "Citeseer", "Pubmed"):
        return presets(graph, predictor, epochs=epochs, runs=1)
    if graph == "ppa":
        # degree-100 synthetic at a CPU-trainable batch: the adj2_cap
        # sensitivity proxy for the full-scale ppa preset
        return presets("ppa", predictor, epochs=epochs, runs=1,
                       batch_size=4096, testbs=8192, linkbatchsize=512)
    return Config(  # sbm
        dataset="sbm", predictor=predictor, model="puregcn", mplayers=1,
        hiddim=64, batch_size=2048, testbs=4096, epochs=epochs, runs=1,
        maskinput=True, ln=True, lnnn=True, res=True,
        gnndp=0.1, xdp=0.1, tdp=0.1, gnnedp=0.0, predp=0.1, preedp=0.1,
        gnnlr=0.01, prelr=0.01,
    )


def variant_overrides(name: str, max_deg: int) -> dict:
    """The variant's fields; ``max_deg`` sets the exact arms' widths (the
    next power of two, at least 8).  Every name of the JAX script's table,
    including arms no longer run."""
    pad_exact = 1 << int(np.ceil(np.log2(max(max_deg, 8))))
    capped = dict(pad_deg=64, pad_deg2=64, two_hop_mode="gather")
    table = {
        # exact CN sets + exact two-hop counts (reference semantics)
        "exact": dict(pad_deg=pad_exact, pad_deg2=pad_exact,
                      two_hop_mode="sddmm"),
        # caps without the ELL tables, then the production default with them
        "capped": dict(capped, adj2_cap=1024, ell_tables=False),
        "capped_ell": dict(capped, adj2_cap=1024, ell_tables=True),
        "capped128_ell": dict(pad_deg=128, pad_deg2=128, two_hop_mode="gather",
                              adj2_cap=1024, ell_tables=True),
        # dual-K occupancy split
        "capped_k16": dict(capped, adj2_cap=1024, k_small=16, ell_tables=False),
        # exact widths in gather mode, capped widths in sddmm mode
        "exact_gather": dict(pad_deg=pad_exact, pad_deg2=pad_exact,
                             two_hop_mode="gather", adj2_cap=4096,
                             ell_tables=False),
        "capped_sddmm": dict(pad_deg=64, pad_deg2=64, two_hop_mode="sddmm",
                             ell_tables=False),
        # incomplete family: the recursion width rec_k
        "rec8": dict(capped, adj2_cap=1024, rec_k=8, ell_tables=False),
        "rec16": dict(capped, adj2_cap=1024, rec_k=16, ell_tables=False),
        # cn3 at a shared eval residual width tstdeg 32
        "capped_t32": dict(capped, adj2_cap=1024, tstdeg=32, ell_tables=False),
        "rec16_t32": dict(capped, adj2_cap=1024, rec_k=16, tstdeg=32,
                          ell_tables=False),
        # A^2 row cap on a degree-100 graph
        "adj2cap256": dict(capped, adj2_cap=256, ell_tables=True),
        "adj2cap1024": dict(capped, adj2_cap=1024, ell_tables=True),
        # harsh caps
        "hard16": dict(pad_deg=16, pad_deg2=16, two_hop_mode="gather",
                       adj2_cap=256, ell_tables=False),
        "hard8": dict(pad_deg=8, pad_deg2=8, two_hop_mode="gather",
                      adj2_cap=128, ell_tables=False),
        # dual-K at chunk sizes that engage the split
        "lb256": dict(capped, adj2_cap=1024, linkbatchsize=256,
                      ell_tables=False),
        "lb256_k16": dict(capped, adj2_cap=1024, linkbatchsize=256,
                          k_small=16, ell_tables=False),
        # cn6's estimator chain: the exact cubic fallback, the production
        # chain (host A^3 capped at adj3_cap, tbl3), and one knob at a time
        "x3_exact": dict(pad_deg=pad_exact, pad_deg2=pad_exact,
                         two_hop_mode="sddmm", k3=pad_exact, ell_tables=False),
        "x3_prod": dict(capped, adj2_cap=1024, adj3_cap=256, ell_tables=True),
        "x3_noell": dict(capped, adj2_cap=1024, adj3_cap=256, ell_tables=False),
        "x3_cap64": dict(capped, adj2_cap=1024, adj3_cap=64, ell_tables=True),
        "x3_cap1024": dict(capped, adj2_cap=1024, adj3_cap=1024,
                           ell_tables=True),
        "x3_k8": dict(capped, adj2_cap=1024, adj3_cap=256, k3=8,
                      ell_tables=True),
        "x3_k32": dict(capped, adj2_cap=1024, adj3_cap=256, k3=32,
                       ell_tables=True),
        "lb128": dict(capped, adj2_cap=1024, linkbatchsize=128,
                      ell_tables=False),
        "lb128_k16": dict(capped, adj2_cap=1024, linkbatchsize=128,
                          k_small=16, ell_tables=False),
    }
    return table[name]


def arm(graph: str, variant: str, run_i: int, epochs: int,
        predictor: str = "cn5", scale: float = 1.0
        ) -> Tuple[LinkDataset, Config]:
    """The dataset (seed ``run_i``, BFS-relabelled when the config says so)
    and Config of one run of an arm."""
    ds = loaddataset(graph, seed=run_i, synthetic_scale=scale)
    deg = np.bincount(np.asarray(ds.edge_index[0]), minlength=ds.n_nodes)
    cfg = base_config(graph, epochs, predictor)
    for k, v in variant_overrides(variant, int(deg.max())).items():
        setattr(cfg, k, v)
    # a preset's batch_size can exceed a stand-in's train edges, and the
    # drop-tail iterator would then run no batch at all: clamp to the
    # largest power of two that fits (the same for every arm of a graph)
    e_train = int(np.asarray(ds.split_edge["train"]["edge"]).shape[0])
    if cfg.batch_size > e_train:
        cfg.batch_size = max(256, 1 << int(np.log2(e_train)))
        cfg.testbs = min(cfg.testbs, cfg.batch_size)
        cfg.linkbatchsize = min(cfg.linkbatchsize or cfg.batch_size,
                                cfg.batch_size)
        print(f"  [batch clamp] {cfg.batch_size} (train edges {e_train})",
              flush=True)
    if cfg.reorder == "bfs":
        ds = ds.reorder_bfs()
    return ds, cfg


def converge(trainer: Trainer, state: TrainState, rng: np.random.Generator,
             epochs: int, eval_every: int, label: str = ""
             ) -> Tuple[List[float], Dict[str, List[float]]]:
    """Train ``epochs`` epochs, evaluating every ``eval_every`` epochs and at
    the last; returns the per-epoch losses and, per Hits@K, the (train,
    valid, test) of the best validation so far."""
    losses: List[float] = []
    best: Dict[str, List[float]] = {}
    for epoch in range(1, epochs + 1):
        state, loss = trainer.train_epoch(state, rng, epoch)
        losses.append(loss)
        if epoch % eval_every and epoch != epochs:
            continue
        res = trainer.evaluate(state)
        for key, (trn, val, tst) in res.items():
            if key not in best or val > best[key][1]:
                best[key] = [trn, val, tst]
        print(f"  [{label}] ep{epoch} loss {loss:.4f} "
              f"H@50 val {res['Hits@50'][1]:.4f} tst {res['Hits@50'][2]:.4f}",
              flush=True)
    return losses, best


def card() -> Tuple[str, str]:
    """(name, power limit) of the first card as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return name, limit


def run_one(graph: str, variant: str, run_i: int, epochs: int,
            eval_every: int, predictor: str = "cn5", scale: float = 1.0,
            device: str = "cuda") -> dict:
    """One run of an arm: its JSON record."""
    dev = resolve_device(device)
    name, limit = card() if dev.type == "cuda" else ("cpu", None)
    ds, cfg = arm(graph, variant, run_i, epochs, predictor, scale)
    launches0 = M.membership_counts.launches
    tr = Trainer(cfg, ds, device=dev)
    state = tr.init_state(run_i)
    rng = np.random.default_rng(run_i)
    t0 = time.time()
    losses, best = converge(tr, state, rng, epochs, eval_every,
                            f"{variant} r{run_i}")
    return {
        "graph": graph, "variant": variant, "run": run_i,
        "predictor": predictor, "scale": scale,
        "epochs": epochs, "wall_s": round(time.time() - t0, 1),
        "pad_deg": cfg.pad_deg, "two_hop_mode": cfg.two_hop_mode,
        "k_small": cfg.k_small, "adj3_cap": cfg.adj3_cap, "k3": cfg.k3,
        "best": {k: [round(x, 5) for x in v] for k, v in best.items()},
        "package": "ocn_tpu_torch", "device": name, "power_limit": limit,
        "membership_launches": M.membership_counts.launches - launches0,
        "losses": losses,
    }


def read_records(paths) -> List[dict]:
    rows = []
    for path in paths:
        with open(path) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    return rows


def arms(rows: List[dict]) -> Dict[tuple, List[dict]]:
    """Records by (graph, predictor, variant)."""
    agg: Dict[tuple, List[dict]] = {}
    for r in rows:
        agg.setdefault((r["graph"], r.get("predictor", "cn5"),
                        r["variant"]), []).append(r)
    return agg


def print_table(path: str) -> None:
    """The JAX script's aggregate table of one output file."""
    print("| graph | pred | variant | runs | Hits@50 val | Hits@50 test | Hits@100 test |")
    print("|---|---|---|---|---|---|---|")
    for (g, p, v), rs in sorted(arms(read_records([path])).items()):
        h50v = np.array([x["best"]["Hits@50"][1] for x in rs])
        h50t = np.array([x["best"]["Hits@50"][2] for x in rs])
        h100t = np.array([x["best"]["Hits@100"][2] for x in rs])
        print(f"| {g} | {p} | {v} | {len(rs)} "
              f"| {h50v.mean():.4f}±{h50v.std():.4f} "
              f"| {h50t.mean():.4f}±{h50t.std():.4f} "
              f"| {h100t.mean():.4f}±{h100t.std():.4f} |")


def _spread(x: np.ndarray) -> Tuple[int, float, float]:
    """n, mean and sample sd (nan for one value)."""
    sd = float(x.std(ddof=1)) if len(x) > 1 else float("nan")
    return len(x), float(x.mean()), sd


def compare(ref: List[dict], port: List[dict]) -> List[dict]:
    """For each arm present in both record lists: per Hits@K of HITS, the
    best test value's n, mean and sample sd on each side, the difference of
    the means (port minus reference) and the two-sided Welch p."""
    from scipy import stats

    ra, pa = arms(ref), arms(port)
    out = []
    for key in sorted(set(ra) & set(pa)):
        row = {"arm": key}
        for hits in HITS:
            a = np.array([r["best"][hits][2] for r in ra[key]])
            b = np.array([r["best"][hits][2] for r in pa[key]])
            p = float(stats.ttest_ind(b, a, equal_var=False).pvalue)
            row[hits] = {"ref": _spread(a), "port": _spread(b),
                         "diff": float(b.mean() - a.mean()), "p": p}
        out.append(row)
    return out


def print_comparison(ref_paths, path: str) -> None:
    rows = compare(read_records(ref_paths), read_records([path]))
    print("| graph | pred | variant | ref n | ref test H@50 | port n "
          "| port test H@50 | diff | Welch p | p H@20 | p H@100 |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for row in rows:
        h = row["Hits@50"]
        (na, ma, sa), (nb, mb, sb) = h["ref"], h["port"]
        print(f"| {' | '.join(row['arm'])} | {na} | {ma:.4f}±{sa:.4f} | {nb} "
              f"| {mb:.4f}±{sb:.4f} | {h['diff']:+.4f} | {h['p']:.3g} "
              f"| {row['Hits@20']['p']:.3g} | {row['Hits@100']['p']:.3g} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="sbm")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--eval_every", type=int, default=3)
    ap.add_argument("--variants", default="exact,capped,capped_k16,hard16")
    ap.add_argument("--predictor", default="cn5")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="synthetic graph scale (e.g. 0.005 for the ppa "
                         "degree-100 rows)")
    ap.add_argument("--out", default="results/parity.jsonl")
    ap.add_argument("--table", action="store_true",
                    help="only print the aggregate table from --out")
    ap.add_argument("--against", nargs="+", default=None, metavar="FILE",
                    help="with --table: reference records to hold --out's "
                         "arms against")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.table:
        print_table(args.out)
        if args.against:
            print_comparison(args.against, args.out)
        return
    resolve_device(args.platform)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        done = {(r["graph"], r["variant"], r["run"], r.get("predictor", "cn5"))
                for r in read_records([args.out])}
    for variant in args.variants.split(","):
        for run_i in range(args.runs):
            key = (args.graph, variant, run_i, args.predictor)
            if key in done:
                print(f"skip {key} (done)", flush=True)
                continue
            print(f"=== {key}", flush=True)
            rec = run_one(args.graph, variant, run_i, args.epochs,
                          args.eval_every, args.predictor, args.scale,
                          device=args.platform)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print_table(args.out)


if __name__ == "__main__":
    main()

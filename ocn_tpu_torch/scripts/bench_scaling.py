"""Weak-scaling harness (port of scripts/bench_scaling.py): the same work a
rank, S_PERDEV links of each sign, at dp 1, 2, 4 and 8 ranks.

    python -m ocn_tpu_torch.scripts.bench_scaling                        # ranks on the card
    OCN_BENCH_PLATFORM=cpu python -m ocn_tpu_torch.scripts.bench_scaling  # gloo ranks on the CPU

S_MODE picks the step: "spmd" (the explicit DP step, parallel/spmd.py),
"sharded" (the bare node-sharded step, parallel/sharded_graph.py
ShardedGraphStep over a mesh of dp ranks, with its mask routing) or
"sharded_prod" (node sharding through the Trainer's own config path, with
ELL table shards and the dual-K interleave; at dp 1 the Trainer takes its
single-device step, as the JAX Trainer does).  The graph is synthetic Cora
at scale 1.0.  Each dp is one launch of dp ranks (parallel/launch.py): two
warm steps, a barrier, 3 timed steps up to a loss read on the host; the
step time is the slowest rank's.  The line gives ms a step, links scored a
second (2 * batch) and the efficiency against dp 1 at the same work a rank.

The JAX script runs a virtual 8-device CPU mesh by default.  Here the ranks
of one card share it (gloo, through host memory; parallel/launch.py
backend_for), so the numbers check the machinery, its collectives and its
overheads, and are no interconnect efficiency.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ocn_tpu_torch.scripts.bench import bench_device

DPS = (1, 2, 4, 8)
MODES = ("spmd", "sharded", "sharded_prod")
STEPS = 3


def scaling_config(mode: str, dp: int, per_dev: int):
    """The JAX script's Config of ``mode`` at ``dp`` ranks."""
    from ocn_tpu_torch.config import Config

    b = per_dev * dp
    prod = mode == "sharded_prod"
    return Config(
        dataset="Cora", predictor="cn5", model="puregcn", mplayers=1,
        hiddim=64, batch_size=b, testbs=b, maskinput=True,
        pad_deg=32, pad_deg2=32,
        # sharded_prod needs >= 2 chunks a rank, so that each holds one
        # small and one big dual-K chunk
        linkbatchsize=per_dev // 2 if prod else per_dev,
        ell_tables=prod,
        **({"graph_sharding": "node", "dp_devices": dp, "k_small": 8,
            "small_frac": 0.5, "small_frac_neg": 0.5} if prod else {}),
    )


def scaling_dataset():
    from ocn_tpu_torch.data.loaders import synthetic_dataset

    return synthetic_dataset("Cora", seed=0, scale=1.0)


def scaling_inputs(ds, b: int, edge2pos):
    """The batch of the JAX script, drawn from ``default_rng(0)``: (2, b)
    positives (a permutation of the train edges, wrapped where b exceeds
    them), (2, b) negatives, their train-edge indices, and the mask
    positions of the positives (``edge2pos`` rows, -1 clipped to 0)."""
    from ocn_tpu_torch.sparse import build as B

    rng = np.random.default_rng(0)
    pos = ds.split_edge["train"]["edge"].T
    e = pos.shape[1]
    idx = rng.permutation(max(e, b))[:b] % e
    neg = B.negative_sampling(ds.edge_index, ds.n_nodes, b, rng)
    mp = np.maximum(edge2pos[idx].reshape(-1), 0)
    return pos[:, idx], neg, idx, mp


def make_step(tr, mode: str, dp: int, device, pos_b, neg, idx, mp):
    """step(state, gen) -> (state, loss) of ``mode`` on this rank, its
    inputs staged once (the ELL tables of sharded_prod built from
    ``default_rng(1)`` first)."""
    if mode == "sharded_prod":
        if tr._use_ell:
            tr._refresh_ell(np.random.default_rng(1))
        pe, ne, m, ip, inn = tr.prepare_batch(pos_b, neg, idx)
        return lambda state, gen: tr.train_step(state, pe, ne, m, gen, ip, inn)
    from ocn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp, 1, device)
    pe = torch.as_tensor(np.asarray(pos_b), dtype=torch.int64, device=device)
    ne = torch.as_tensor(np.asarray(neg), dtype=torch.int64, device=device)
    if mode == "sharded":
        from ocn_tpu_torch.parallel.sharded_graph import ShardedGraphStep

        sg = ShardedGraphStep(tr, mesh)
        # the host's mask positions, routed to this rank's shards each step
        return lambda state, gen: sg.step(state, pe, ne, mp, gen)
    from ocn_tpu_torch.parallel.spmd import make_spmd_train_step

    step = make_spmd_train_step(tr, mesh)
    mpt = torch.as_tensor(mp, dtype=torch.int64, device=device)
    return lambda state, gen: step(state, pe, ne, mpt, gen)


def rank_body(info, dp: int, per_dev: int, modes, steps: int = STEPS) -> dict:
    """Every mode of ``modes`` on this rank: two warm steps (on one card the
    step program's warm-up and capture, train/step_graph.py), a barrier,
    then ``steps`` timed steps up to the last loss's host read.  Returns
    {mode: {"ms": ms a step, "losses": the warm steps', then the timed ones',
    "membership_launches": the kernel's launches over all the steps}}."""
    import torch.distributed as dist

    from ocn_tpu_torch.ops import membership as M
    from ocn_tpu_torch.train.loop import Trainer

    dev = info.device
    ds = scaling_dataset()
    out = {}
    for mode in modes:
        cfg = scaling_config(mode, dp, per_dev)
        tr = Trainer(cfg, ds, device=dev)
        pos_b, neg, idx, mp = scaling_inputs(ds, cfg.batch_size, tr.edge2pos)
        step = make_step(tr, mode, dp, dev, pos_b, neg, idx, mp)
        state = tr.init_state(0)
        gen = torch.Generator(device=dev).manual_seed(0)
        M.membership_counts.launches = 0
        losses = []
        for _ in range(2):
            state, loss = step(state, gen)
            losses.append(loss.item())
        dist.barrier()
        t0 = time.perf_counter()
        timed = []
        for _ in range(steps):
            state, loss = step(state, gen)
            timed.append(loss)
        losses += [t.item() for t in timed]  # the last waits for the card
        out[mode] = {"ms": 1e3 * (time.perf_counter() - t0) / steps,
                     "losses": losses,
                     "membership_launches": M.membership_counts.launches}
    return out


def run_dp(dp: int, per_dev: int, modes=MODES, device="cuda", steps: int = STEPS,
           body=rank_body, **launch_kw) -> list:
    """One launch of ``dp`` ranks running ``body`` (rank_body or a wrapper
    of it with its arguments); returns every rank's result."""
    from ocn_tpu_torch.parallel.launch import launch

    return launch(body, dp, dp, per_dev, tuple(modes), steps, device=device,
                  **launch_kw)


def scaling_line(dp: int, b: int, ms: float, eps: float, eff: float) -> str:
    """The JAX script's line of one dp."""
    return (f"dp={dp} batch={b}: {ms:.1f} ms/step -> {eps:.0f} edges/s "
            f"(weak-scaling eff {eff * 100:.0f}%)")


def rows(mode: str, per_dev: int, by_dp: dict) -> list:
    """The rows of ``mode`` from {dp: rank results}: dp, batch, the slowest
    rank's ms a step, links a second, the efficiency against dp 1 (1.0 where
    dp 1 did not run)."""
    out, base = [], None
    for dp in sorted(by_dp):
        b = per_dev * dp
        ms = max(r[mode]["ms"] for r in by_dp[dp])
        eps = 2 * b / (ms * 1e-3)
        if dp == 1:
            base = eps
        eff = eps / (base * dp) if base else 1.0
        out.append({"dp": dp, "batch": b, "ms": ms, "edges_per_s": eps,
                    "efficiency": eff})
    return out


def main() -> list:
    """The harness for S_MODE at S_PERDEV; prints a line a dp and returns
    the rows."""
    device = bench_device()
    per_dev = int(os.environ.get("S_PERDEV", "512"))
    mode = os.environ.get("S_MODE", "spmd")
    by_dp = {}
    for dp in DPS:
        by_dp[dp] = run_dp(dp, per_dev, (mode,), device)
        row = rows(mode, per_dev, by_dp)[-1]
        print(scaling_line(dp, row["batch"], row["ms"], row["edges_per_s"],
                           row["efficiency"]), flush=True)
    return rows(mode, per_dev, by_dp)


if __name__ == "__main__":
    main()

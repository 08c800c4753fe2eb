"""Benchmark program of the port (counterpart of the root bench.py):
training throughput (links/s) of the flagship cn5/OCN program on a
collab-scale graph, on one card.

    python -m ocn_tpu_torch.scripts.bench                        # the CUDA device
    OCN_BENCH_PLATFORM=cpu python -m ocn_tpu_torch.scripts.bench  # the CPU

It reads bench.py's OCN_BENCH_* knobs with the same defaults and the same
per-dataset shapes, builds the same Config, synthetic dataset (BFS
relabelled), ELL tables (their refresh charged to the step time as bench.py
charges it), negatives, permutation and pre-staged batches, and times
OCN_BENCH_STEPS training steps after two untimed ones (the JAX script's
one warm-up step compiles its program; the port's takes two, a warm-up and
a capture, train/step_graph.py), up to a
``loss.item()`` that waits for the card.  It prints ONE JSON line with
bench.py's keys: ``metric`` (train_edges_per_s_{predictor}_{dataset}),
``value``, ``unit``, ``vs_baseline`` (``baseline_note`` where there is no
denominator), the two speed anchors of the card taken in the same run
(OCN_BENCH_ANCHORS=1, the default), and for a variant run with
OCN_BENCH_PAIR=1 (the default) the paired defaults run
(``ref_defaults_metric``, ``ref_defaults_value``, ``vs_defaults``).

The dropout streams differ from the JAX package's: it folds a key per
step, the port draws every step from one torch.Generator seeded 0.
"""
import json
import os
import time

import numpy as np
import torch

# bench.py's own denominator: its estimate of the reference PyTorch/CUDA
# stack on one A100 (ogbl-collab cn5, ~60k edges/s; BASELINE.md), not a
# measurement
A100_REF_EDGES_PER_S = 60_000.0
DATASET_BASELINES = {"collab": A100_REF_EDGES_PER_S}

# env knobs that select a non-default program (bench.py's list): a variant
# line carries a paired defaults run as its denominator
_VARIANT_ENVS = (
    "OCN_BENCH_SCALE", "OCN_BENCH_BATCH", "OCN_BENCH_CHUNK", "OCN_BENCH_HOIST",
    "OCN_BENCH_GROUP", "OCN_BENCH_PREDICTOR", "OCN_BENCH_DATASET",
    "OCN_BENCH_KSMALL", "OCN_BENCH_K2DST",
    "OCN_BENCH_WINDOW", "OCN_BENCH_DTYPE", "OCN_BENCH_ELL",
    "OCN_BENCH_ADJ2CAP", "OCN_BENCH_REORDER", "OCN_BENCH_RECK",
    "OCN_BENCH_PREEDP",
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_device() -> str:
    """The device of the bench programs: the card, or the CPU with
    OCN_BENCH_PLATFORM=cpu."""
    return "cpu" if os.environ.get("OCN_BENCH_PLATFORM") == "cpu" else "cuda"


def chip_anchors(device="cuda", n=235_868, b=4096, mm=4096, gather_reps=20,
                 matmul_reps=10):
    """Speed anchors of the device, taken in the same run as the program:
    a (b,) row gather of an (n, 64) int32 table by plain tensor indexing and
    an mm^3 bfloat16 torch.matmul, each repetition chained on the one before
    (its offset is the last result mod 4).  Returns (gather ms a repetition,
    matmul TFLOP/s); timed by CUDA events on the card, by the host clock on
    the CPU.  The sizes shrink for a test on the CPU."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    tbl = torch.as_tensor(
        rng.integers(0, 2**31, size=(n, 64), dtype=np.int64).astype(np.int32),
        device=dev)
    rows = torch.as_tensor(rng.integers(0, n - 8, size=b, dtype=np.int64),
                           device=dev)
    m = torch.as_tensor(rng.standard_normal((mm, mm)), dtype=torch.bfloat16,
                        device=dev)

    def timeit(body, reps):
        s = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(reps):  # warm-up
            s = body(s)
        _sync(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                s = body(s)
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            s = body(s)
        return (time.perf_counter() - t0) / reps * 1e3

    g_ms = timeit(lambda s: torch.remainder(tbl[rows + s].view(-1)[0], 4).long(),
                  gather_reps)
    mm_ms = timeit(lambda s: torch.remainder(
        torch.matmul(m + s.to(torch.bfloat16), m).view(-1)[0].float().long(), 4),
        matmul_reps)
    return round(g_ms, 3), round(2 * mm**3 / (mm_ms * 1e-3) / 1e12, 1)


def bench_config(defaults: bool = False):
    """(Config, scale, steps, BFS relabel) of the bench program from the OCN_BENCH_*
    knobs, as bench.py's measure builds them; ``defaults`` ignores every
    variant knob (OCN_BENCH_STEPS still counts)."""
    from ocn_tpu_torch.config import Config

    env = (lambda k, d: d) if defaults else (
        lambda k, d: os.environ.get(k, d))
    scale = float(env("OCN_BENCH_SCALE", "1.0"))
    batch = int(env("OCN_BENCH_BATCH", "65536"))
    steps = int(os.environ.get("OCN_BENCH_STEPS", "10"))
    chunk = int(env("OCN_BENCH_CHUNK", "4096"))
    hoist = env("OCN_BENCH_HOIST", "0") == "1"
    group = int(env("OCN_BENCH_GROUP", "8"))

    predictor = env("OCN_BENCH_PREDICTOR", "cn5")
    dataset = env("OCN_BENCH_DATASET", "collab")
    # per-dataset shapes of the reference's drivers (bench.py:105-128):
    # citation2 (randint-target negatives, ho stack, hiddim 64), ddi
    # (puresum, hiddim 224), ppa's README preset shape unless
    # OCN_BENCH_PPA_SHAPE=collab
    shape = {}
    if dataset == "citation2":
        batch = int(env("OCN_BENCH_BATCH", "32768"))
        chunk = int(env("OCN_BENCH_CHUNK", "2048"))
        shape = dict(model="puregcn", hiddim=64, encoder_stack="ho",
                     cn2_counts=True, neg_mode="randint_target")
    elif dataset == "ddi":
        batch = int(env("OCN_BENCH_BATCH", "24576"))
        shape = dict(model="puresum", hiddim=224)
    elif dataset == "ppa" and env("OCN_BENCH_PPA_SHAPE", "preset") == "preset":
        batch = int(env("OCN_BENCH_BATCH", "16384"))
        chunk = int(env("OCN_BENCH_CHUNK", "512"))
        shape = dict(model="gcn", hiddim=64, mplayers=1, encoder_stack="ho",
                     cn2_counts=True, ln=False, res=False, jk=False,
                     gnndp=0.1, xdp=0.1, tdp=0.1, gnnedp=0.1, predp=0.1,
                     preedp=0.0)
    adj2cap_default = {"citation2": "128", "ppa": "1024"}.get(dataset, "1024")
    base = dict(
        dataset=dataset, predictor=predictor, model="gcn", mplayers=3,
        hiddim=256, batch_size=batch, testbs=batch, maskinput=True,
        ln=True, res=True, jk=True, use_xlin=True, tailact=True,
        gnndp=0.25, xdp=0.25, tdp=0.05, gnnedp=0.25, predp=0.3, preedp=0.3,
        pad_deg=64, pad_deg2=64, linkbatchsize=chunk, hoist_frames=hoist,
        frame_group=group,
        k_small=int(env("OCN_BENCH_KSMALL", "16")),
        pad_deg2_dst=int(env("OCN_BENCH_K2DST", "0")),
        window_table=env("OCN_BENCH_WINDOW", "0") == "1",
        dtype=env("OCN_BENCH_DTYPE", "bfloat16"),
        ell_tables=env("OCN_BENCH_ELL", "1") == "1",
        adj2_cap=int(env("OCN_BENCH_ADJ2CAP", adj2cap_default)),
        rec_k=int(env("OCN_BENCH_RECK", "0")),
    )
    base.update(shape)
    cfg = Config(**base)
    if env("OCN_BENCH_PREEDP", "") != "":
        cfg.preedp = float(env("OCN_BENCH_PREEDP", "0.3"))
    reorder = env("OCN_BENCH_REORDER", "bfs") == "bfs"
    return cfg, scale, steps, reorder


def bench_inputs(ds, cfg, steps: int):
    """(pos, neg, batch indices) as bench.py draws them from seed 0: the
    (2, E) train edges, negatives (randint targets for citation2's
    neg_mode), and ``steps`` batches of a permutation (the first batch again
    where the permutation runs short)."""
    from ocn_tpu_torch.sparse import build as B

    batch = cfg.batch_size
    e = ds.split_edge["train"]["edge"].shape[0]
    rng = np.random.default_rng(0)
    pos = ds.split_edge["train"]["edge"].T
    if cfg.neg_mode == "randint_target":
        neg = np.stack([pos[0], rng.integers(0, ds.n_nodes, size=e)])
    else:
        neg = B.negative_sampling(ds.edge_index, ds.n_nodes, e, rng)
    perm = rng.permutation(e)[: batch * max(1, steps)]
    idxs = []
    for i in range(max(1, steps)):
        idx = perm[(i % max(1, len(perm) // batch)) * batch:][:batch]
        if len(idx) < batch:
            idx = perm[:batch]
        idxs.append(idx)
    return pos, neg, idxs


def measure(defaults: bool = False, device="cuda"):
    """Run the bench program on ``device``; returns (metric name, links
    scored per second).  ``defaults=True`` measures the canonical defaults
    program whatever the variant knobs say (the paired run's denominator)."""
    from ocn_tpu_torch.data.loaders import synthetic_dataset
    from ocn_tpu_torch.train.loop import Trainer

    cfg, scale, steps, reorder = bench_config(defaults)
    ds = synthetic_dataset(cfg.dataset, seed=0, scale=scale)
    if reorder:
        # BFS relabelling clusters the neighbor gathers
        ds = ds.reorder_bfs()
    tr = Trainer(cfg, ds, device=device)
    state = tr.init_state(0)
    dev = tr.device
    e = ds.split_edge["train"]["edge"].shape[0]

    refresh_s = 0.0
    if tr._use_ell:
        # the program drives train_step, not train_epoch: build the ELL
        # tables here, and charge their per-epoch rebuild to the step time
        # below (amortised over the steps of an epoch)
        tr._refresh_ell(np.random.default_rng(1))
        _sync(dev)
        t0 = time.perf_counter()
        tr._refresh_ell(np.random.default_rng(2))
        _sync(dev)
        refresh_s = time.perf_counter() - t0
    pos, neg, idxs = bench_inputs(ds, cfg, steps)
    # every step's inputs staged on the device before the timed region
    batches = [tr.prepare_batch(pos[:, idx], neg[:, idx], idx) for idx in idxs]
    gen = torch.Generator(device=dev).manual_seed(0)

    # two untimed steps: on the card the step program's warm-up and its
    # capture (train/step_graph.py); every timed step is one replay
    for pe, ne, mp, inv_p, inv_n in (batches * 2)[:2]:
        state, loss = tr.train_step(state, pe, ne, mp, gen, inv_p, inv_n)
    loss.item()

    t0 = time.perf_counter()
    done = 0
    for pe, ne, mp, inv_p, inv_n in batches[:steps]:
        state, loss = tr.train_step(state, pe, ne, mp, gen, inv_p, inv_n)
        done += 2 * cfg.batch_size  # positive and negative links scored
    loss.item()  # waits for the card
    dt = time.perf_counter() - t0
    steps_per_epoch = max(1, e // cfg.batch_size)
    dt += steps * refresh_s / (steps_per_epoch * max(1, cfg.ell_refresh))
    return f"train_edges_per_s_{cfg.predictor}_{cfg.dataset}", done / dt


def main(anchors=None) -> dict:
    """The bench program: prints its one JSON line and returns it as a
    dict.  ``anchors`` are keyword arguments of chip_anchors (sizes)."""
    device = bench_device()
    metric, eps = measure(device=device)
    dataset = os.environ.get("OCN_BENCH_DATASET", "collab")
    base = DATASET_BASELINES.get(dataset)
    rec = {
        "metric": metric,
        "value": round(eps, 1),
        "unit": "edges/s",
        "vs_baseline": round(eps / base, 3) if base else None,
    }
    if base is None:
        rec["baseline_note"] = (
            f"no offline cross-framework anchor for {dataset!r}; "
            "see chip anchors for the drift denominator")
    if os.environ.get("OCN_BENCH_ANCHORS", "1") == "1":
        g_ms, mm_tflops = chip_anchors(device, **(anchors or {}))
        rec["anchor_rowgather_ms"] = g_ms
        rec["anchor_matmul_tflops"] = mm_tflops
    is_variant = any(os.environ.get(k) for k in _VARIANT_ENVS)
    if is_variant and os.environ.get("OCN_BENCH_PAIR", "1") == "1":
        ref_metric, ref_eps = measure(defaults=True, device=device)
        rec["ref_defaults_metric"] = ref_metric
        rec["ref_defaults_value"] = round(ref_eps, 1)
        rec["vs_defaults"] = round(eps / ref_eps, 3)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()

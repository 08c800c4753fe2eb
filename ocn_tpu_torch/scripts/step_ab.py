"""Time the train step of one checkout of the port on one card, eager and,
where the checkout has it, captured as a CUDA graph, so that two checkouts
(a commit and its parent) can be compared.

    python ocn_tpu_torch/scripts/step_ab.py --root DIR [--steps 6]

imports ``ocn_tpu_torch`` from the checkout at DIR and runs bench.py's
program at its defaults (DIR's ``scripts/bench.py bench_config``: cn5, gcn
x 3 at hidden 256, batch 65,536 in chunks of 4,096, ELL tables, the dual-K
split, frame groups of 8, bfloat16 features) on the synthetic collab
stand-in at scale 1.0, BFS-relabelled, the ELL tables from
``default_rng(1)``, the batches and negatives from ``default_rng(0)``, the
same inputs whatever DIR is.  For each mode, eager (``Trainer(...,
capture=False)``, or the checkout's only step when its Trainer takes no
``capture``) and captured (the default of a checkout that has it), a
fresh Trainer from seed 0 runs ``--steps`` steps one at a time, each timed
on the host clock up to its ``loss.item()`` (with capture, step 1 is the
program's warm-up, step 2 its capture and first replay, the rest
replays), then one more step untimed and the same step under
``torch.profiler`` (this checkout's ``utils/profiling.py``): the card's
busy ms, its activities and the busy share against the untraced step.
Then DIR's bench program (``scripts/bench.py measure``) at its defaults
and with ``OCN_BENCH_WINDOW=1``: links scored a second over 10 steps
queued back to back.

One JSON line per checkout, with the card's name and power limit as
nvidia-smi gives them.  Run each checkout in a process of its own, in one
call of the card, in the order A, B, B, A, so that drift of the card's
clocks shows.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time


def load_profiling():
    """This checkout's utils/profiling.py, whatever package DIR holds."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "step_ab_profiling", os.path.join(here, "utils", "profiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_mode(torch, np, profiling, ds, cfg, capture, steps):
    """``steps`` timed steps and a profiled one of a fresh Trainer."""
    from ocn_tpu_torch.sparse import build as B
    from ocn_tpu_torch.train.loop import Trainer

    kw = {} if capture is None else {"capture": capture}
    tr = Trainer(cfg, ds, device="cuda", **kw)
    state = tr.init_state(0)
    tr._refresh_ell(np.random.default_rng(1))
    rng = np.random.default_rng(0)
    e = tr.train_edges.shape[1]
    neg = B.negative_sampling(ds.edge_index, ds.n_nodes, e, rng)
    perm = rng.permutation(e)
    bs = cfg.batch_size
    if (steps + 1) * bs > e:
        raise ValueError(f"{steps + 1} batches of {bs} need more than {e} train edges")
    idxs = [perm[i * bs:(i + 1) * bs] for i in range(steps + 1)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []

    def step(idx):
        inputs = tr.prepare_batch(tr.train_edges[:, idx], neg[:, idx], idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = tr.train_step(state, *inputs[:3], gen, *inputs[3:])
        out = loss.item()
        return out, 1e3 * (time.perf_counter() - t0)

    for idx in idxs[:steps]:
        loss, ms = step(idx)
        losses.append(loss)
        step_ms.append(ms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, untraced_ms = step(idxs[steps])
    inputs = tr.prepare_batch(tr.train_edges[:, idxs[steps]], neg[:, idxs[steps]],
                              idxs[steps])
    torch.cuda.synchronize()
    _, prof = profiling.profile_region(
        lambda: tr.train_step(state, *inputs[:3], gen, *inputs[3:])[1].item())
    program = getattr(tr, "_program", None)
    rec = {"step_ms": step_ms, "losses": losses, "peak_mem_train_gb": peak,
           "untraced_step_ms": untraced_ms,
           "device_busy_ms": prof["device_busy_ms"],
           "device_busy_share": prof["device_busy_ms"] / untraced_ms,
           "device_busy_share_traced": prof["device_busy_share"],
           "device_activities": prof["device_activities"],
           "traced_ms": prof["window_ms"], "kernel_classes": prof["kernel_classes"],
           "top_kernels": prof["top_kernels"][:5]}
    if program is not None:
        rec.update(captured=program.capture, capture_s=program.capture_s,
                   replays=program.replays)
    del tr, state
    torch.cuda.empty_cache()
    return rec


def bench_program(torch, window):
    """DIR's bench measure at its defaults, or its window variant."""
    from ocn_tpu_torch.scripts import bench

    keys = [k for k in os.environ if k.startswith("OCN_BENCH_")]
    saved = {k: os.environ.pop(k) for k in keys}
    if window:
        os.environ["OCN_BENCH_WINDOW"] = "1"
    try:
        torch.cuda.reset_peak_memory_stats()
        metric, eps = bench.measure(defaults=False)
        return {"metric": metric, "edges_per_s": eps,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        os.environ.pop("OCN_BENCH_WINDOW", None)
        os.environ.update(saved)
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="root of the checkout whose train step is timed")
    ap.add_argument("--steps", type=int, default=6,
                    help="timed steps a mode (default 6)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_ab: no CUDA device is available", file=sys.stderr)
        return 1
    profiling = load_profiling()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import ocn_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(ocn_tpu_torch.__file__))) != root:
        raise RuntimeError(f"imported {ocn_tpu_torch.__file__}, not the one in {root}")
    from ocn_tpu_torch.data.loaders import synthetic_dataset
    from ocn_tpu_torch.scripts import bench
    from ocn_tpu_torch.train.loop import Trainer

    # full float32 matrix products, as the JAX reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    cfg, scale, _, _ = bench.bench_config(defaults=True)
    t0 = time.perf_counter()
    ds = synthetic_dataset(cfg.dataset, seed=0, scale=scale).reorder_bfs()
    data_s = time.perf_counter() - t0
    modes = ({"eager": False, "captured": True}
             if "capture" in inspect.signature(Trainer.__init__).parameters
             else {"eager": None})
    out = {name: run_mode(torch, np, profiling, ds, cfg, capture, args.steps)
           for name, capture in modes.items()}
    del ds
    out["bench_program"] = bench_program(torch, window=False)
    out["bench_program_window"] = bench_program(torch, window=True)
    print(json.dumps({"root": args.root, "nvidia_smi": smi, "data_s": data_s,
                      "steps": args.steps, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

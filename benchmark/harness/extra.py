"""Runs that are not runs of the program: the graph statistics of a seed
(``--describe``) and the readings that the limits were set from
(``--control``): the reference computed with TF32 matmuls, and for the train
cells with half of each batch left out of the loss, each put in the
program's place against the float32 reference."""
from __future__ import annotations

import time
from typing import Dict

import torch

from harness import compare, core, graphgen


def _cell(name: str):
    wl = core.load_json("workloads", f"{name}.json")
    cfg = core.load_json("configs", f"{wl['config']}.json")
    return wl, cfg


def describe(name: str, seed: int) -> Dict:
    from reference import _ocn as R

    wl, cfg = _cell(name)
    m = cfg["model"]
    t0 = time.perf_counter()
    data = graphgen.make_graph(cfg["graph"], seed, "cuda")
    t1 = time.perf_counter()
    out = {"cell": name, "seed": seed, "data_s": t1 - t0,
           **graphgen.degree_stats(data, m["pad_deg"], m["k_small"])}
    d = R.relabel(data)
    for key, edges in (("a2_train", d["train"]),
                       ("a2_train_valid", torch.cat([torch.as_tensor(d["train"]),
                                                     torch.as_tensor(d["valid"])]).numpy())):
        g = R.graph(edges, d["n"], "cuda")
        a2 = R.two_hop(g, m["adj2_cap"])
        out[key] = {"adjacency_entries": g.nnz, "entries": a2.nnz,
                    "rows_capped": int((a2.deg_np >= m["adj2_cap"]).sum()),
                    "largest_count": float(a2.val.max()), "packs": R.packs(a2, d["n"])}
        del g, a2
    out["stats"] = graphgen.work_stats(data, m)
    return out


def control(name: str, seed: int) -> Dict:
    wl, cfg = _cell(name)
    entry = core.load_file("entries", wl["entry"])
    cell = entry.Cell(cfg, wl["traffic"], seed, "cuda")
    cell.data = graphgen.make_graph(cfg["graph"], seed, "cuda")
    ref = core.import_reference(cfg["name"])
    out = {"cell": name, "seed": seed}
    t0 = time.perf_counter()
    if wl["entry"] == "train_epochs":
        steps = int(wl["traffic"]["ref_steps"])
        base = ref.train(cfg, cell.data, seed, steps, "cuda")
        out["reference_s"] = time.perf_counter() - t0
        low = ref.train(cfg, cell.data, seed, steps, "cuda", tf32=True)
        out["tf32"] = compare.train_readings(low, base)[0]
        del low
        half = ref.train(cfg, cell.data, seed, steps, "cuda", fault="half_batch")
        out["half_batch"] = compare.train_readings(half, base)[0]
    else:
        base = ref.evaluate(cfg, cell.data, seed, "cuda")
        out["reference_s"] = time.perf_counter() - t0
        low = ref.evaluate(cfg, cell.data, seed, "cuda", tf32=True)
        out["tf32"] = {"score_gap": compare.eval_numbers(low, base)}
    return out

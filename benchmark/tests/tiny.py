"""Tiny configurations of the benchmark's cells, for runs on the CPU."""
import copy
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = {"batch_size": 512, "testbs": 512, "linkbatchsize": 64, "hiddim": 32,
         "pad_deg": 8, "pad_deg2": 8, "k_small": 4, "adj2_cap": 32}
GRAPH = {"n_nodes": 800, "n_features": 16, "edges": 4000, "train": 3200,
         "valid": 400, "test": 400, "neg_valid": 400, "neg_test": 400,
         "zipf_exponent": 0.5}


def config(name: str) -> dict:
    """configs/<name>.json cut to a tiny graph and model (``overrides``)."""
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["overrides"] = dict(SMALL)
    cfg["model"].update(SMALL)
    cfg["graph"] = dict(GRAPH)
    return cfg


def traffic(cell: str) -> dict:
    with open(os.path.join(BENCH_DIR, "workloads", f"{cell}.json")) as f:
        return json.load(f)["traffic"]

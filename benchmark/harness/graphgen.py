"""The benchmark's graph, made from the seed.

A frozen copy of the port's synthetic stand-in (``synthetic_edges`` and
``randomsplit`` of ocn_tpu_torch/data/loaders.py, ``symmetrize_edge_index``
and the NumPy ``negative_sampling`` of ocn_tpu_torch/sparse/build.py), sized
to a configuration's ``graph`` block instead of the stand-in's scale knobs:
exactly ``edges`` undirected edges, split ``test`` / ``valid`` / ``train`` in
that order from one permutation (as ``randomsplit`` carves them), and
``neg_valid`` + ``neg_test`` non-edges against the whole graph.  Endpoints are
drawn from the Zipf-tilted node law w_i ~ (1 + i)^-exponent; features are
standard normal.  The program never sees the seed: it gets these arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def data_rng(seed: int) -> np.random.Generator:
    """The generator of a run's data (graph, split, negatives, features)."""
    return np.random.default_rng([int(seed), 0])


def train_rng(seed: int) -> np.random.Generator:
    """The generator a run hands to every ``train_epoch`` call, in order."""
    return np.random.default_rng([int(seed), 1])


def symmetrize(edge_index: np.ndarray, n: int) -> np.ndarray:
    """(2, E) -> both directions, deduplicated, no self loops, sorted by
    (row, col) key (``symmetrize_edge_index``)."""
    ei = np.asarray(edge_index, np.int64)
    both = np.concatenate([ei, ei[::-1]], axis=1)
    both = both[:, both[0] != both[1]]
    key = np.unique(both[0] * np.int64(n) + both[1])
    return np.stack([key // n, key % n]).astype(np.int64)


def undirected_edges(n: int, n_edges: int, exponent: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Exactly ``n_edges`` distinct undirected edges (u < v), (n_edges, 2):
    Zipf-tilted endpoint pairs (``synthetic_edges``) drawn in rounds until
    enough distinct ones exist, then a uniform subset of that many."""
    w = (1.0 / (1.0 + np.arange(n)) ** exponent).astype(np.float64)
    w /= w.sum()
    keys = np.empty(0, np.int64)
    draw = n_edges + n_edges // 8
    for _ in range(16):
        src = rng.choice(n, size=draw, p=w)
        dst = rng.choice(n, size=draw, p=w)
        keep = src != dst
        lo = np.minimum(src[keep], dst[keep]).astype(np.int64)
        hi = np.maximum(src[keep], dst[keep]).astype(np.int64)
        keys = np.unique(np.concatenate([keys, lo * n + hi]))
        if keys.size >= n_edges:
            break
        draw = (n_edges - keys.size) * 2 + 1024
    if keys.size < n_edges:
        raise RuntimeError(f"{keys.size} distinct edges after 16 rounds, "
                           f"{n_edges} asked for")
    keys = keys[np.sort(rng.permutation(keys.size)[:n_edges])]
    return np.stack([keys // n, keys % n], axis=1)


def negative_sampling(edge_index: np.ndarray, n: int, num: int,
                      rng: np.random.Generator) -> np.ndarray:
    """``num`` uniform non-edges (2, num) by rejection against the sorted
    edge keys (the NumPy ``negative_sampling``)."""
    ei = np.asarray(edge_index, np.int64)
    skeys = np.sort(ei[0] * n + ei[1])
    out = np.empty(num, np.int64)
    filled = 0
    for _ in range(8):
        need = num - filled
        if need <= 0:
            break
        cand = rng.integers(0, n, size=(2, int(need * 1.3) + 8))
        key = cand[0] * n + cand[1]
        mask = cand[0] != cand[1]
        idx = np.minimum(np.searchsorted(skeys, key), len(skeys) - 1)
        mask &= skeys[idx] != key
        good = key[mask]
        take = min(need, good.shape[0])
        out[filled:filled + take] = good[:take]
        filled += take
    if filled < num:
        raise RuntimeError(f"negative sampling filled {filled} of {num}")
    return np.stack([out // n, out % n])


def make_graph(graph: Dict, seed: int, device: str = "cpu") -> Dict[str, np.ndarray]:
    """The arrays of one run: ``x`` (n, F) float32, ``train``, ``valid``,
    ``test`` (E, 2) positive edges (u < v), ``valid_neg`` and ``test_neg``
    (E, 2) non-edges, and ``n``.  The features are drawn on ``device`` by a
    torch generator seeded from the seed (one call), the rest on the host."""
    n = int(graph["n_nodes"])
    rng = data_rng(seed)
    und = undirected_edges(n, int(graph["edges"]), float(graph["zipf_exponent"]), rng)
    sizes = (int(graph["test"]), int(graph["valid"]), int(graph["train"]))
    if sum(sizes) != und.shape[0]:
        raise ValueError(f"split {sizes} does not add up to {und.shape[0]} edges")
    und = und[rng.permutation(und.shape[0])]
    test = und[:sizes[0]]
    valid = und[sizes[0]:sizes[0] + sizes[1]]
    train = und[sizes[0] + sizes[1]:]
    nv, nt = int(graph["neg_valid"]), int(graph["neg_test"])
    neg = negative_sampling(symmetrize(und.T, n), n, nv + nt, rng)
    x = features(n, int(graph["n_features"]), seed, device)
    return {"n": n, "x": x, "train": train, "valid": valid, "test": test,
            "valid_neg": neg[:, :nv].T.copy(), "test_neg": neg[:, nv:].T.copy()}


def features(n: int, f: int, seed: int, device: str = "cpu") -> np.ndarray:
    """(n, f) standard normal float32 features, drawn in one call."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return torch.randn((n, f), generator=gen, device=device).cpu().numpy()


def degree_stats(data: Dict[str, np.ndarray], pad_deg: int, k_small: int) -> Dict:
    """Degree quantiles of the train graph and the shares of rows above
    ``pad_deg`` (capped frames) and at or below ``k_small`` (the dual-K
    split's small body), over nodes and over train-edge sources."""
    n = data["n"]
    ei = symmetrize(data["train"].T, n)
    deg = np.bincount(ei[0], minlength=n)
    src = deg[data["train"][:, 0]]
    q = [0.5, 0.9, 0.99, 0.999, 1.0]
    return {"degree_quantiles": dict(zip([str(v) for v in q],
                                         np.quantile(deg, q).tolist())),
            "nodes_above_pad_deg": float(np.mean(deg > pad_deg)),
            "nodes_at_most_k_small": float(np.mean(deg <= k_small)),
            "train_sources_above_pad_deg": float(np.mean(src > pad_deg)),
            "train_sources_at_most_k_small": float(np.mean(src <= k_small)),
            "max_degree": int(deg.max())}


def link_chunk(model: Dict) -> int:
    """Links a training chunk holds: the largest divisor of batch_size at
    most linkbatchsize (4096 where that is not positive)."""
    b = int(model["batch_size"])
    target = int(model["linkbatchsize"]) if int(model["linkbatchsize"]) > 0 else 4096
    return next(c for c in range(min(b, target), 0, -1) if b % c == 0)


def work_stats(data: Dict[str, np.ndarray], model: Dict) -> Dict:
    """The sizes the per-layer metrics count work from, taken from the run's
    arrays (degrees do not depend on the nodes' labels): nodes, features,
    adjacency entries of the train and train+valid graphs, the chunks of a
    step and how many of them the dual-K split sends to the narrow frame,
    and for each eval split its links and how many of them score narrow."""
    n = data["n"]
    deg = np.bincount(symmetrize(data["train"].T, n)[0], minlength=n)
    full = symmetrize(np.concatenate([data["train"], data["valid"]]).T, n)
    degf = np.bincount(full[0], minlength=n)
    b, c, ks = int(model["batch_size"]), link_chunk(model), int(model["k_small"])
    nchunk = b // c
    nsp = min(nchunk, int(float(np.mean(deg[data["train"][:, 0]] <= ks)) * nchunk))
    nsn = min(nchunk, int(float(np.mean(deg <= ks)) * nchunk))
    tb = int(model["testbs"])
    splits = {}
    for name, dg in (("train", deg), ("valid", deg), ("valid_neg", deg),
                     ("test", degf), ("test_neg", degf)):
        e = data[name]
        small = 0
        if model["dual_k_eval"] and 0 < ks < int(model["pad_deg"]) and e.shape[0] > tb:
            small = (int(np.sum(dg[e[:, 0]] <= ks)) // tb) * tb
        splits[name] = {"links": int(e.shape[0]), "narrow": small}
    return {"n": n, "features": int(data["x"].shape[1]), "hidden": int(model["hiddim"]),
            "nnz": int(deg.sum()), "nnz_full": int(degf.sum()),
            "batch": b, "chunk": c, "chunks": 2 * nchunk,
            "narrow_chunks": nsp + nsn if nsp + nsn else 0,
            "pad_deg": int(model["pad_deg"]), "pad_deg2": int(model["pad_deg2"]),
            "k_small": ks, "testbs": tb,
            "steps_per_epoch": data["train"].shape[0] // b, "eval_splits": splits}

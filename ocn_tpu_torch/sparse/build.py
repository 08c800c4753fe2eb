"""Host-side graph construction (NumPy; optional C++ fast path).

Replaces the reference's torch_sparse construction pipeline
(`SparseTensor.from_edge_index(...).to_symmetric().coalesce()`,
reference ogbdataset.py:44-45) with plain NumPy that produces the static CSR
arrays consumed by ocn_tpu_torch.sparse.csr.Graph.

A C++ implementation of the hot host paths lives in native/graphcore.cpp and is
used automatically when the compiled library is present (see
ocn_tpu_torch.utils.native); the NumPy code below is the always-available fallback
and the reference implementation for its tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ocn_tpu_torch.utils import native


def symmetrize_edge_index(edge_index: np.ndarray, n_nodes: int) -> np.ndarray:
    """Return undirected, deduplicated, self-loop-free edge list (2, E').

    Matches `to_symmetric().coalesce()` semantics of the reference
    (ogbdataset.py:45): both directions present, duplicates merged.
    Self loops are dropped (the reference's edge lists contain none).
    """
    ei = np.asarray(edge_index, np.int64)
    both = np.concatenate([ei, ei[::-1]], axis=1)
    both = both[:, both[0] != both[1]]
    key = both[0] * np.int64(n_nodes) + both[1]
    key = np.unique(key)
    return np.stack([key // n_nodes, key % n_nodes]).astype(np.int64)


def csr_from_edge_index(
    edge_index: np.ndarray, n_nodes: int, symmetrize: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (indptr, col) CSR with per-row-sorted columns."""
    if symmetrize:
        edge_index = symmetrize_edge_index(edge_index, n_nodes)
    nat = native.load()
    if nat is not None:
        return nat.csr_from_edges(edge_index, n_nodes)
    row, col = edge_index[0], edge_index[1]
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    counts = np.bincount(row, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr.astype(np.int32), col.astype(np.int32)


def edge_to_nnz_positions(
    indptr: np.ndarray, col: np.ndarray, edges: np.ndarray
) -> np.ndarray:
    """For each undirected edge (u, v), find its nnz positions (u->v, v->u).

    Precomputed once per dataset so that the per-batch target-link removal
    ("maskinput", reference NeighborOverlap_large.py:56-63) is a scatter of
    zeros instead of a rebuild.  Returns (E, 2) int32; -1 where a direction is
    absent from the adjacency (cannot happen for train edges of a symmetrized
    train graph, but kept safe).
    """
    nat = native.load()
    if nat is not None:
        return nat.edge_to_nnz_positions(indptr, col, edges)
    edges = np.asarray(edges, np.int64)
    out = np.full((edges.shape[1], 2), -1, np.int64)
    for k, (a, b) in enumerate(((0, 1), (1, 0))):
        u, v = edges[a], edges[b]
        lo, hi = indptr[u], indptr[u + 1]
        # binary search of v within col[lo:hi] (columns sorted per row)
        pos = lo + np.array(
            [np.searchsorted(col[l:h], t) for l, h, t in zip(lo, hi, v)]
        )
        ok = (pos < hi) & (col[np.minimum(pos, col.shape[0] - 1)] == v)
        out[:, k] = np.where(ok, pos, -1)
    return out.astype(np.int32)


def spgemm_csr(
    ip_a: np.ndarray, col_a: np.ndarray, val_a, ip_b: np.ndarray,
    col_b: np.ndarray, val_b, n_nodes: int, cap: int = 1024,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-capped weighted C = A @ B in CSR (val_a/val_b None => all-ones).

    Host SpGEMM used to chain higher-order expansions — A^3 = A^2 @ A for the
    cn6 predictor (the reference computes per-batch `adj3` with cuSPARSE;
    model.py:2447-2954 consumes it via adjoverlap).  C++ fast path
    (native/graphcore.cpp gc_spgemm_csr); NumPy fallback below.
    """
    nat = native.load()
    if nat is not None:
        out = nat.spgemm_csr(ip_a, col_a, val_a, ip_b, col_b, val_b, n_nodes, cap)
        if out is not None:
            return out
    ip_a = np.asarray(ip_a, np.int64)
    col_a = np.asarray(col_a, np.int64)
    ip_b = np.asarray(ip_b, np.int64)
    col_b = np.asarray(col_b, np.int64)
    va = None if val_a is None else np.asarray(val_a, np.float64)
    vb = None if val_b is None else np.asarray(val_b, np.float64)
    out_i = [0]
    cols_all, vals_all = [], []
    for j in range(n_nodes):
        acc: dict = {}
        for p in range(ip_a[j], ip_a[j + 1]):
            m = col_a[p]
            wa = 1.0 if va is None else float(va[p])
            if wa == 0.0:
                continue
            for q in range(ip_b[m], ip_b[m + 1]):
                wb = 1.0 if vb is None else float(vb[q])
                if wb == 0.0:
                    continue
                k = int(col_b[q])
                acc[k] = acc.get(k, 0.0) + wa * wb
        uniq = np.asarray(sorted(acc.keys()), np.int64)
        counts = np.asarray([acc[int(k)] for k in uniq], np.float64)
        if cap > 0 and len(uniq) > cap:
            keep = np.argsort(-counts, kind="stable")[:cap]
            keep.sort()
            uniq, counts = uniq[keep], counts[keep]
        cols_all.append(uniq)
        vals_all.append(counts)
        out_i.append(out_i[-1] + len(uniq))
    out_col = (
        np.concatenate(cols_all).astype(np.int32) if cols_all else np.empty(0, np.int32)
    )
    out_val = (
        np.concatenate(vals_all).astype(np.float32) if vals_all else np.empty(0, np.float32)
    )
    return np.asarray(out_i, np.int32), out_col, out_val


def adj2_csr(
    indptr: np.ndarray, col: np.ndarray, n_nodes: int, cap: int = 1024
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-capped A^2 = A @ A in CSR with path-count values.

    Replaces the reference's per-batch cuSPARSE SpGEMM
    (NeighborOverlap_large.py:74) / dense-block `--adj2byblock`
    (utils.py:287-329) with a one-time host SpGEMM; rows longer than ``cap``
    keep their highest-count entries.  C++ fast path in native/graphcore.cpp;
    NumPy fallback below.
    """
    nat = native.load()
    if nat is not None:
        return nat.adj2_csr(indptr, col, n_nodes, cap)
    indptr = np.asarray(indptr, np.int64)
    col = np.asarray(col, np.int64)
    out_i = [0]
    cols_all, vals_all = [], []
    for j in range(n_nodes):
        nbrs = col[indptr[j] : indptr[j + 1]]
        if len(nbrs) == 0:
            out_i.append(out_i[-1])
            continue
        segs = [col[indptr[m] : indptr[m + 1]] for m in nbrs]
        two = np.concatenate(segs) if segs else np.empty(0, np.int64)
        uniq, counts = np.unique(two, return_counts=True)
        if cap > 0 and len(uniq) > cap:
            keep = np.argsort(-counts, kind="stable")[:cap]
            keep.sort()
            uniq, counts = uniq[keep], counts[keep]
            order = np.argsort(uniq)
            uniq, counts = uniq[order], counts[order]
        cols_all.append(uniq)
        vals_all.append(counts)
        out_i.append(out_i[-1] + len(uniq))
    out_col = (
        np.concatenate(cols_all).astype(np.int32) if cols_all else np.empty(0, np.int32)
    )
    out_val = (
        np.concatenate(vals_all).astype(np.float32) if vals_all else np.empty(0, np.float32)
    )
    return np.asarray(out_i, np.int32), out_col, out_val


def edge_keys(edge_index: np.ndarray, n_nodes: int) -> np.ndarray:
    """The sorted int64 keys u * n_nodes + v of the edges (u, v)."""
    ei = np.asarray(edge_index, np.int64)
    return np.sort(ei[0] * n_nodes + ei[1])


def negative_seed(rng: np.random.Generator) -> int:
    """The seed of one draw of the native sampler (and of the card's,
    ops/negatives.py): one integer from ``rng``."""
    return int(rng.integers(1, 2**62))


def negative_sampling(
    edge_index: np.ndarray,
    n_nodes: int,
    num_samples: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Sample `num_samples` non-edges, PyG-style (reference
    NeighborOverlap_large.py:51 `negative_sampling(edge_index, N)`).

    Uniform (u, v) proposals rejected against the existing edge set, with
    oversampling rounds until filled; raises if the graph is so dense that
    rejection sampling cannot fill the request (silently degenerate negatives
    would corrupt training).
    """
    rng = rng or np.random.default_rng()
    skeys = edge_keys(edge_index, n_nodes)
    nat = native.load()
    if nat is not None:
        keys = nat.negative_sampling(skeys, n_nodes, num_samples, negative_seed(rng))
        if keys.shape[0] == num_samples:
            return np.stack([keys // n_nodes, keys % n_nodes]).astype(np.int64)
    return rejection_rounds(skeys, n_nodes, num_samples, rng)


def rejection_rounds(skeys: np.ndarray, n_nodes: int, num_samples: int,
                     rng: np.random.Generator) -> np.ndarray:
    """``negative_sampling``'s NumPy rounds against the sorted edge keys
    ``skeys``: where no native sampler is built, or it returned short."""
    out = np.empty(num_samples, np.int64)
    filled = 0
    for _ in range(8):
        need = num_samples - filled
        if need <= 0:
            break
        cand = rng.integers(0, n_nodes, size=(2, int(need * 1.3) + 8))
        key = cand[0] * n_nodes + cand[1]
        mask = cand[0] != cand[1]
        # membership against the sorted edge-key array
        idx = np.minimum(np.searchsorted(skeys, key), len(skeys) - 1)
        mask &= skeys[idx] != key
        good = key[mask]
        take = min(need, good.shape[0])
        out[filled : filled + take] = good[:take]
        filled += take
    if filled < num_samples:  # pathological near-complete graph
        raise RuntimeError(
            f"negative_sampling filled only {filled}/{num_samples} after 8 "
            f"rejection rounds (graph too dense: {skeys.shape[0]} edges over "
            f"{n_nodes} nodes); reduce num_samples or sample negatives "
            "another way"
        )
    return np.stack([out // n_nodes, out % n_nodes]).astype(np.int64)

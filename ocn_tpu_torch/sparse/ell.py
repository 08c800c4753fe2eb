"""ELL window tables: per-node neighbor samples in a row-gatherable layout
(port of ocn_tpu/sparse/ell.py).

A table freezes each row's window offset for a refresh interval (an epoch by
default): row r holds the packed col|val entries of the CSR window
[indptr[r] + off[r], +K).  A batch's neighbor gather (ops/frame.py
gather_neighbors) is then one (B,) row gather of the (N, K) table instead of
a (B, K) flat-position gather.  Only rows with degree > K are affected by the
freeze (they get a uniform window sample); rows with degree <= K are exact
either way.

The offsets are drawn on the host (``draw_offsets``) so the trainer can
compute maskinput positions in table space without device gathers; the table
itself is built on the tables' device (``build_ell``), once per refresh.
Entries are the packed layout of Graph.packed (csr.py), so masking an entry
clears its value bits and one table serves ids and values.
"""
from __future__ import annotations

import numpy as np
import torch


def draw_offsets(deg: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform window offset per row: 0 for rows with deg <= k, else
    U{0, deg-k}, so every entry has inclusion probability k/deg."""
    slack = np.maximum(deg.astype(np.int64) - k, 0)
    off = (rng.random(deg.shape[0]) * (slack + 1)).astype(np.int64)
    return np.minimum(off, slack).astype(np.int32)


def build_ell(packed: torch.Tensor, indptr: torch.Tensor, off: torch.Tensor,
              k: int) -> torch.Tensor:
    """(n_nodes, k) int32 table: row r = packed[indptr[r]+off[r] : ... +k].

    Lanes past a row's degree read into the next CSR row; consumers mask them
    with the degree as the CSR window path does (the GATHER_PAD tail in
    csr.py keeps end-of-array reads in bounds)."""
    lane = torch.arange(k, dtype=torch.int64, device=packed.device)
    pos0 = indptr[:-1].long() + off.long()
    pos = torch.clamp(pos0[:, None] + lane, max=packed.shape[0] - 1)
    return packed[pos]


def build_ell_np(packed: np.ndarray, indptr: np.ndarray, off: np.ndarray,
                 k: int) -> np.ndarray:
    """Host (NumPy) build_ell."""
    pos0 = indptr[:-1].astype(np.int64) + off.astype(np.int64)
    pos = np.minimum(
        pos0[:, None] + np.arange(k, dtype=np.int64)[None, :],
        packed.shape[0] - 1)
    return packed[pos]


def mask_ell_flat_positions(
    edges: np.ndarray, mask_positions: np.ndarray, indptr: np.ndarray,
    off: np.ndarray, k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Host side: flat table positions of the batch's masked edges and the
    cleared packed values to write there.

    ``edges`` (2, B) are the batch's positive edges in the order of
    ``mask_positions`` (2 CSR positions per edge: u->v then v->u, the
    edge2pos layout).  A direction lies in row r's frozen window iff
    0 <= csr_pos - indptr[r] - off[r] < k; directions outside it are not in
    the table and get position -1, which apply_ell_mask drops.  The cleared
    value is the partner's node id (a packed entry with zero value bits)."""
    rows = np.stack([edges[0], edges[1]], axis=1).ravel()
    partners = np.stack([edges[1], edges[0]], axis=1).ravel()
    lane = mask_positions.astype(np.int64) - indptr[rows] - off[rows]
    ok = (lane >= 0) & (lane < k) & (mask_positions >= 0)
    flat = np.where(ok, rows.astype(np.int64) * k + lane, -1)
    return flat.astype(np.int32), partners.astype(np.int32)


def apply_ell_mask(tbl: torch.Tensor, flat_positions: torch.Tensor,
                   cleared: torch.Tensor) -> torch.Tensor:
    """A copy of ``tbl`` with ``cleared`` written at ``flat_positions``;
    -1 positions are dropped.

    Index -1 would wrap to the table's last entry (in torch as in JAX) and
    delete a real neighbor whenever row n-1 has degree >= k.  So the write
    goes into a flat buffer of n*k + 1 entries whose last slot is a sink for
    the -1 positions, and the sink is cut off afterwards.  No boolean filter:
    it would force a host sync on the card."""
    n, k = tbl.shape
    buf = torch.cat([tbl.reshape(-1), tbl.new_zeros(1)])
    idx = torch.where(flat_positions < 0, n * k, flat_positions).long()
    buf[idx] = cleared.to(tbl.dtype)
    return buf[: n * k].reshape(n, k)

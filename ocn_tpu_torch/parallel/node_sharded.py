"""Node-sharded SpMM (port of ocn_tpu/parallel/node_sharded.py).

Node features are sharded over the "dp" ranks in contiguous node ranges
(``rows_per`` rows each, the last range padded), and the adjacency is
partitioned by destination row, each rank holding the CSR slice of its
range.  The partitions are host NumPy, built as in the JAX package (pad
entries carry ``val == 0``), stacked (ndev, ...) with rank d's slice at
[d].  Three SpMMs, each computing rank d's rows of A @ x from its shard
``x_local`` (rows_per, H):

* ``make_node_sharded_spmm``: all-gather every shard, then the local
  segment sum (the dense exchange);
* ``make_boundary_spmm``: only the halo: each rank sends each peer the rows
  it needs in one all-to-all, and aggregates its interior entries from its
  own shard and its boundary entries from the received rows;
* ``make_ring_spmm``: the shards travel around the ring, one send/receive
  a step, each rank adding the entries whose sources it holds that step.

Their gradients go through the collectives' transposes
(parallel/launch.py: all-gather <-> reduce-scatter, all-to-all <-> itself,
the ring shift <-> the reverse shift).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ocn_tpu_torch.ops.segment_sum import segment_sum_by
from ocn_tpu_torch.parallel.launch import AllGatherRows, AllToAll, RingShift
from ocn_tpu_torch.sparse.csr import Graph


def _coo(g: Graph):
    ip = g.indptr.cpu().numpy()
    nnz = int(ip[-1])
    return (ip, g.col.cpu().numpy()[:nnz], g.row.cpu().numpy()[:nnz],
            g.val.cpu().numpy()[:nnz])


@dataclasses.dataclass
class GraphPartition:
    """Per-rank CSR slice: rows [offset, offset + rows_per), arrays padded
    to a common nnz length; pad entries carry val == 0."""

    row_offsets: np.ndarray      # (ndev,)
    rows_per: int
    col: np.ndarray              # (ndev, m) int32 global source ids
    local_row: np.ndarray        # (ndev, m) int32 row - offset
    val: np.ndarray              # (ndev, m) float32
    boundary_counts: np.ndarray  # (ndev,) distinct off-partition sources


def partition_graph(g: Graph, ndev: int) -> GraphPartition:
    ip, col, row, val = _coo(g)
    n = g.n_nodes
    rows_per = -(-n // ndev)
    cols, lrows, vals, offs, bnd = [], [], [], [], []
    for d in range(ndev):
        r0, r1 = d * rows_per, min((d + 1) * rows_per, n)
        lo, hi = ip[r0], ip[min(r1, n)]
        cols.append(col[lo:hi])
        lrows.append((row[lo:hi] - r0).astype(np.int32))
        vals.append(val[lo:hi])
        offs.append(r0)
        src = np.unique(col[lo:hi])
        bnd.append(int(((src < r0) | (src >= r1)).sum()))
    m = max(len(c) for c in cols) if cols else 1

    def pad(arrs, fill, dtype):
        return np.stack([
            np.concatenate([a, np.full(m - len(a), fill, dtype)]).astype(dtype)
            for a in arrs])

    return GraphPartition(
        row_offsets=np.asarray(offs, np.int32), rows_per=rows_per,
        col=pad(cols, 0, np.int32), local_row=pad(lrows, rows_per - 1, np.int32),
        val=pad(vals, 0.0, np.float32), boundary_counts=np.asarray(bnd, np.int64))


@dataclasses.dataclass
class BoundaryPartition:
    """Boundary-only exchange plan: each rank ships exactly the rows its
    peers need (the halo).  Index arrays are host-precomputed from the
    graph."""

    rows_per: int
    bmax: int                   # halo rows shipped per (sender, receiver) pair
    send_idx: np.ndarray        # (ndev, ndev, bmax) sender-local row ids
    icol: np.ndarray            # (ndev, imax) interior source ids (local)
    irow: np.ndarray            # (ndev, imax) interior destination rows (local)
    ival: np.ndarray            # (ndev, imax)
    bpos: np.ndarray            # (ndev, jmax) flat inbox positions s*bmax+rank
    brow: np.ndarray            # (ndev, jmax) boundary destination rows
    bval: np.ndarray            # (ndev, jmax)
    halo_fraction: float        # shipped rows / full all-gather rows


def partition_graph_boundary(g: Graph, ndev: int) -> BoundaryPartition:
    ip, col, row, val = _coo(g)
    n = g.n_nodes
    rows_per = -(-n // ndev)
    needs = [[np.zeros(0, np.int64)] * ndev for _ in range(ndev)]
    interior, boundary = [], []
    for d in range(ndev):
        r0, r1 = d * rows_per, min((d + 1) * rows_per, n)
        lo, hi = ip[r0], ip[min(r1, n)]
        c, r, v = col[lo:hi], (row[lo:hi] - r0).astype(np.int32), val[lo:hi]
        own = (c >= r0) & (c < r0 + rows_per)
        interior.append((c[own] - r0, r[own], v[own]))
        boundary.append((c[~own], r[~own], v[~own]))
        for s in range(ndev):
            if s == d:
                continue
            s0 = s * rows_per
            m = (c >= s0) & (c < s0 + rows_per)
            needs[d][s] = np.unique(c[m])
    bmax = max(1, max(len(needs[d][s]) for d in range(ndev) for s in range(ndev)))
    imax = max(1, max(len(t[0]) for t in interior))
    jmax = max(1, max(len(t[0]) for t in boundary))

    send_idx = np.zeros((ndev, ndev, bmax), np.int32)
    for s in range(ndev):
        for d in range(ndev):
            ids = needs[d][s] - s * rows_per
            send_idx[s, d, :len(ids)] = ids  # pad with sender-local row 0
    icol = np.zeros((ndev, imax), np.int32)
    irow = np.full((ndev, imax), rows_per - 1, np.int32)
    ival = np.zeros((ndev, imax), np.float32)
    bpos = np.zeros((ndev, jmax), np.int32)
    brow = np.full((ndev, jmax), rows_per - 1, np.int32)
    bval = np.zeros((ndev, jmax), np.float32)
    shipped = 0
    for d in range(ndev):
        c, r, v = interior[d]
        icol[d, :len(c)], irow[d, :len(c)], ival[d, :len(c)] = c, r, v
        c, r, v = boundary[d]
        s = c // rows_per
        rank = np.zeros(len(c), np.int64)
        for sd in range(ndev):
            m = s == sd
            if m.any():
                rank[m] = np.searchsorted(needs[d][sd], c[m])
        bpos[d, :len(c)] = (s * bmax + rank).astype(np.int32)
        brow[d, :len(c)], bval[d, :len(c)] = r, v
        shipped += sum(len(needs[d][sd]) for sd in range(ndev))
    halo_fraction = shipped / float(ndev * (ndev - 1) * rows_per) if ndev > 1 else 0.0
    return BoundaryPartition(
        rows_per=rows_per, bmax=bmax, send_idx=send_idx, icol=icol, irow=irow,
        ival=ival, bpos=bpos, brow=brow, bval=bval, halo_fraction=halo_fraction)


def segment_sum(msg: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) sums of msg's rows by ``rows`` (ops/segment_sum.py: a fixed
    order, so one input gives one result on the card)."""
    return segment_sum_by(msg, rows, n)


def _mine(mesh, arr: np.ndarray) -> torch.Tensor:
    """This rank's slice of a stacked (ndev, ...) host array, on its device."""
    t = torch.as_tensor(arr[mesh.dp_rank], device=mesh.device)
    return t.long() if arr.dtype.kind in "iu" else t


def make_node_sharded_spmm(mesh, part: GraphPartition):
    """Returns (spmm, padded_rows): spmm(x_local) with x_local this rank's
    (rows_per, H) shard returns this rank's rows of A @ x.  Dense exchange:
    one all-gather of every shard."""
    col, lrow, val = (_mine(mesh, a) for a in (part.col, part.local_row, part.val))

    def apply(x_local: torch.Tensor) -> torch.Tensor:
        x_full = AllGatherRows.apply(x_local, mesh.comm, mesh.dp_group, "sum")
        return segment_sum(val[:, None].to(x_local.dtype) * x_full[col], lrow,
                            part.rows_per)

    return apply, part.rows_per * mesh.dp


def make_boundary_spmm(mesh, part: BoundaryPartition):
    """Boundary-only exchange: gather the halo rows each peer needs, one
    all-to-all (``halo_fraction`` of the all-gather's rows), aggregate the
    interior entries from the local shard and the boundary entries from the
    inbox."""
    sidx, icol, irow, ival, bpos, brow, bval = (
        _mine(mesh, a) for a in (part.send_idx, part.icol, part.irow, part.ival,
                                 part.bpos, part.brow, part.bval))

    def apply(x_local: torch.Tensor) -> torch.Tensor:
        outbox = x_local[sidx.reshape(-1)]                  # (ndev*bmax, H)
        inbox = AllToAll.apply(outbox, mesh.comm, mesh.dp_group)
        acc = segment_sum(ival[:, None].to(x_local.dtype) * x_local[icol],
                           irow, part.rows_per)
        return acc + segment_sum(bval[:, None].to(x_local.dtype) * inbox[bpos],
                                  brow, part.rows_per)

    return apply, part.rows_per * mesh.dp


def make_ring_spmm(mesh, part: GraphPartition):
    """Ring exchange: the shards rotate around the "dp" ring, one
    send/receive a step; each step every rank adds the entries whose sources
    lie in the shard it holds.  Peak memory is one shard, not all of x."""
    rows_per, ndev, me = part.rows_per, mesh.dp, mesh.dp_rank
    col, lrow, val = (_mine(mesh, a) for a in (part.col, part.local_row, part.val))

    def apply(x_local: torch.Tensor) -> torch.Tensor:
        buf = x_local
        acc = torch.zeros_like(x_local)
        for s in range(ndev):
            r0 = ((me - s) % ndev) * rows_per  # owner of the shard held now
            inr = (col >= r0) & (col < r0 + rows_per)
            li = torch.clamp(col - r0, 0, rows_per - 1)
            w = torch.where(inr, val, 0.0)[:, None].to(x_local.dtype)
            acc = acc + segment_sum(w * buf[li], lrow, rows_per)
            if s < ndev - 1:
                buf = RingShift.apply(buf, mesh.comm, mesh.dp_group, 1)
        return acc

    return apply, rows_per * ndev

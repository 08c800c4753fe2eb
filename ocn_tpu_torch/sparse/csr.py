"""Static-shape sparse graph container (PyTorch tensors).

Port of ocn_tpu/sparse/csr.py.  ``Graph`` holds the adjacency in CSR form
(``indptr``/``col`` for per-row neighbor-window gathers) and COO form
(``row``/``col``/``val`` for segment-sum SpMM) at once.  ``val`` is the only
piece that changes during training: target-link removal ("maskinput") zeroes
values at precomputed nnz positions (``edge2pos``) and DropAdj is value
masking; entries with ``val == 0`` are treated as absent everywhere.  All
edits return a new Graph (the tensors they do not touch are shared).

Host-side construction is NumPy (sparse/build.py); ``graph_from_numpy``
lifts it to CPU tensors and ``Graph.to(device)`` moves it to the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ocn_tpu_torch.ops.segment_sum import segment_sum


@dataclasses.dataclass(frozen=True)
class Graph:
    """Symmetric, coalesced adjacency with per-row-sorted columns.

    indptr : (n_nodes+1,) int32 CSR row pointers.
    col    : (nnz,) int32 column ids, sorted within each row.
    row    : (nnz,) int32 COO row ids (expanded indptr).
    val    : (nnz,) float32 edge values; 0 means masked out / absent.
    deg    : (n_nodes,) int32 structural row degrees (independent of val).
    tpos   : (nnz,) int32 transpose permutation, tpos[p] = position of entry
             (col[p], row[p]); present for symmetric patterns and used by
             the SpMM backward (ops/spmm.py).
    packed : (nnz,) int32 ``col | int(val) << col_bits`` for graphs whose
             values are small non-negative integers, so a neighbor-window
             gather reads one array; dropped by any value mutation except
             masking, which clears the value bits in place.
    ell, ell_off, ell_k : ELL window table (sparse/ell.py): ell[r] holds the
             packed entries of the CSR window [indptr[r]+ell_off[r], +ell_k),
             the per-node neighbor sample frozen for a refresh interval, so a
             batch's neighbor gather is one (B,) row gather.  Any value edit
             drops it (the table holds copies of the values).

    nnz counts GATHER_PAD zero-valued tail entries.  Gather-only graphs (the
    A^2 and A^3 tables) carry indptr/deg/packed, or indptr/deg/col/val when
    the values do not pack, and leave the rest None.
    """

    indptr: torch.Tensor
    col: Optional[torch.Tensor]
    row: Optional[torch.Tensor]
    val: Optional[torch.Tensor]
    deg: torch.Tensor
    n_nodes: int
    tpos: Optional[torch.Tensor] = None
    packed: Optional[torch.Tensor] = None
    col_bits: int = 0
    ell: Optional[torch.Tensor] = None      # (n_nodes, ell_k) int32 packed
    ell_off: Optional[torch.Tensor] = None  # (n_nodes,) int32 window offsets
    ell_k: int = 0

    def with_ell(self, ell: torch.Tensor, ell_off: torch.Tensor) -> "Graph":
        """Attach an ELL window table (requires the packed col|val layout)."""
        return dataclasses.replace(self, ell=ell, ell_off=ell_off,
                                   ell_k=int(ell.shape[1]))

    @property
    def nnz(self) -> int:
        arr = self.col if self.col is not None else self.packed
        return arr.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def to(self, device) -> "Graph":
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, indptr=mv(self.indptr), col=mv(self.col), row=mv(self.row),
            val=mv(self.val), deg=mv(self.deg), tpos=mv(self.tpos),
            packed=mv(self.packed), ell=mv(self.ell), ell_off=mv(self.ell_off))

    def with_values(self, val: torch.Tensor) -> "Graph":
        # value mutation invalidates the packed col|val array and any ELL
        # table built from it
        return dataclasses.replace(self, val=val, packed=None, col_bits=0,
                                   ell=None, ell_off=None, ell_k=0)

    def mask_edges(self, positions: torch.Tensor) -> "Graph":
        """Zero ``val`` at the given nnz positions (maskinput: the batch's
        target links, ``edge2pos[idx].ravel()``).  The packed array keeps
        its column bits and loses its value bits at the same positions, so
        per-row id order is unchanged.  An attached ELL table is dropped:
        it holds copies of the masked entries, and the trainer re-attaches a
        masked table (sparse/ell.py apply_ell_mask)."""
        positions = positions.long()
        out = dataclasses.replace(self, val=self.val.index_fill(0, positions, 0.0))
        if self.packed is not None:
            cleared = self.packed[positions] & ((1 << self.col_bits) - 1)
            out = dataclasses.replace(
                out, packed=self.packed.index_copy(0, positions, cleared))
        if self.ell is not None:
            out = dataclasses.replace(out, ell=None, ell_off=None, ell_k=0)
        return out

    def drop_edges(self, p: float, gen: Optional[torch.Generator] = None,
                   doscale: bool = True) -> "Graph":
        """Value-space DropAdj: keep each nnz with probability 1-p and
        rescale kept values by 1/(1-p)."""
        if p < 1e-6:
            return self
        keep = torch.rand(self.nnz, generator=gen, device=self.device) < 1.0 - p
        scale = 1.0 / (1.0 - p) if doscale else 1.0
        return self.with_values(torch.where(keep, self.val * scale, 0.0))

    def row_offsets(self) -> torch.Tensor:
        """(n_nodes + 1,) int64 segment offsets of the COO entries by row:
        ``indptr`` with the last row stretched over the gather pad, whose row
        ids are the last row's (graph_from_numpy)."""
        off = self.indptr.long()
        return torch.cat([off[:-1], off.new_full((1,), self.nnz)])

    def value_rowsum(self) -> torch.Tensor:
        """Per-row sum of values (the reference's adj.sum(dim=-1)), in the
        sorted segment sum's fixed order (ops/segment_sum.py)."""
        return segment_sum(self.val, self.row_offsets())


# tail padding so neighbor-window gathers never clamp backwards near the end
# of the nnz arrays; padded entries have val == 0 and row/col == 0 (row pads
# with the last row id so it stays sorted)
GATHER_PAD = 4096


def graph_from_numpy(
    indptr: np.ndarray,
    col: np.ndarray,
    n_nodes: int,
    val: Optional[np.ndarray] = None,
    gather_only: bool = False,
) -> Graph:
    """Lift host CSR arrays (sparse/build.py) into a CPU-tensor Graph.

    ``gather_only=True`` keeps only indptr/deg/packed when the values pack
    into the col|val int32 layout (4 bytes per entry instead of 16-20), and
    indptr/deg/col/val (8 bytes) when they do not: path counts of hub pairs
    can pass the packing limit 2^(31 - col_bits).  The JAX package keeps
    the full layout there, whose row and transpose permutation no gather
    reads and whose host sort dominates the set-up at hundreds of millions
    of entries."""
    indptr = np.asarray(indptr, np.int32)
    col = np.asarray(col, np.int32)
    deg = (indptr[1:] - indptr[:-1]).astype(np.int32)
    if val is None:
        val = np.ones_like(col, np.float32)
    nnz = col.shape[0]
    pad = GATHER_PAD
    col = np.concatenate([col, np.zeros(pad, np.int32)])
    val = np.concatenate([np.asarray(val, np.float32), np.zeros(pad, np.float32)])
    packed = None
    col_bits = 0
    vi = val.astype(np.int64)
    if val.size and np.all(val == vi) and vi.min() >= 0:
        col_bits = max(int(n_nodes - 1).bit_length(), 1)
        if vi.max() < (1 << (31 - col_bits)):
            packed = (col.astype(np.int64) | (vi << col_bits)).astype(np.int32)
        else:
            col_bits = 0
    t = torch.from_numpy
    if gather_only:
        return Graph(indptr=t(indptr), deg=t(deg), n_nodes=int(n_nodes),
                     col=None if packed is not None else t(col), row=None,
                     val=None if packed is not None else t(val), tpos=None,
                     packed=t(packed) if packed is not None else None,
                     col_bits=col_bits)
    row = np.repeat(np.arange(n_nodes, dtype=np.int32), deg)
    csc = np.lexsort((row, col[:nnz]))
    tpos = np.empty(nnz, np.int32)
    tpos[csc] = np.arange(nnz, dtype=np.int32)
    pattern_symmetric = bool(
        np.array_equal(row[csc], col[:nnz]) and np.array_equal(col[:nnz][csc], row)
    )
    row = np.concatenate([row, np.full(pad, max(n_nodes - 1, 0), np.int32)])
    tpos = np.concatenate([tpos, np.arange(nnz, nnz + pad, dtype=np.int32)])
    return Graph(
        indptr=t(indptr), col=t(col), row=t(row), val=t(val), deg=t(deg),
        n_nodes=int(n_nodes), tpos=t(tpos) if pattern_symmetric else None,
        packed=t(packed) if packed is not None else None, col_bits=col_bits,
    )

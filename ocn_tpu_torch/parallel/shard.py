"""Within-chunk sharding for the dp x tp mesh step (the port of what GSPMD
does to ocn_tpu's single-device step under ``Config.dp_devices`` /
``tp_devices``, ocn_tpu/train/loop.py:711-734).

The mesh step is the single-device step computed by dp x tp ranks: each
link chunk is split into dp equal row blocks, and the hidden states into tp
column blocks.  While a rank scores its share, a ``RowShard`` is active
(``rows``, a context manager) and the few places where the single-device
step reduces across a chunk, or draws random numbers for it, consult it:

* ``rand``: every draw is the one the single-device step makes; the rank
  draws the full (n_full * m, ...) tensor from the shared generator and
  keeps its rows (``rows`` index the leading dimension of the full batch;
  a leading dimension of n_local * m rows is batch-major, m rows per
  batch row);
* ``dp_sum``, ``dp_max``, ``dp_col_sums``: the chunk-wide sums and maxima
  (the EMA inner product, max|ncn1|, the sorted-domain column sums of
  ops/ortho.py) are reduced over the "dp" group;
* ``row_parallel``: a Dense that receives its tp column share of the hidden
  states computes its partial product with its rows of the weight and sums
  the partials over the "tp" group (its backward is the identity: every tp
  rank consumes the sum alike).  The weight is recorded so the step knows to
  sum its gradient over "tp" as well.

Without an active RowShard every function is the plain single-device
operation.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Set

import torch
import torch.nn.functional as F

from ocn_tpu_torch.ops.segment_sum import segment_sum_by
from ocn_tpu_torch.parallel.launch import AllReduceSum

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("ocn_row_shard",
                                                         default=None)


@dataclasses.dataclass(frozen=True)
class RowShard:
    mesh: object              # parallel.mesh.Mesh
    rows: Optional[torch.Tensor]  # (n_local,) int64 rows of the full batch;
    #                               None over all nodes (``all_nodes``)
    n_full: int               # rows of the full batch
    row_parallel: Set[int]    # id()s of weights computed row-parallel
    hidden: int = 0           # the full width of h (tp shares are narrower)


def current() -> Optional[RowShard]:
    return _ACTIVE.get()


@contextlib.contextmanager
def rows(mesh, local_rows: torch.Tensor, n_full: int, row_parallel: Set[int],
         hidden: int = 0):
    """Make ``local_rows`` of an ``n_full``-row batch this rank's share
    while the block runs (``hidden``: the full width of h)."""
    token = _ACTIVE.set(RowShard(mesh, local_rows, n_full, row_parallel, hidden))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def all_nodes():
    """Work over every node, not over batch rows, inside a RowShard: draws
    and reductions are the plain ones, the tp column share stays."""
    sh = current()
    token = _ACTIVE.set(None if sh is None else dataclasses.replace(sh, rows=None))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _split_dp(sh: Optional[RowShard]) -> bool:
    return sh is not None and sh.mesh.dp > 1 and sh.rows is not None


class _TpColumns(torch.autograd.Function):
    """This rank's column block of a tensor that every tp rank holds whole;
    the backward gathers the blocks' cotangents into the whole one, so the
    (replicated) producer sees the same cotangent on every tp rank."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        w = t.shape[-1] // mesh.tp
        return t[..., mesh.tp_rank * w:(mesh.tp_rank + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = ctx.mesh.comm.all_gather(g.contiguous(), ctx.mesh.tp_group)
        return torch.cat(list(parts.unbind(0)), dim=-1), None


def tp_columns(t: torch.Tensor) -> torch.Tensor:
    """This rank's tp column share of a full-width ``t`` that every tp rank
    computed alike (identity without a tp shard)."""
    sh = current()
    if sh is None or sh.mesh.tp == 1:
        return t
    return _TpColumns.apply(t, sh.mesh)


class _TpSumGrad(torch.autograd.Function):
    """Identity forward; the cotangent summed over "tp" (a tensor every tp
    rank holds whole, consumed by a contraction over h's columns, of which
    each rank holds a share)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.comm.all_reduce(g, ctx.mesh.tp_group), None


def tp_contracted(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t``, whose cotangent is summed over "tp" when it meets an operand
    of ``width`` columns that is a tp share of h (the CN values of a frame
    matmul over h's columns); ``t`` itself otherwise."""
    sh = current()
    if sh is None or sh.mesh.tp == 1 or width == sh.hidden:
        return t
    return _TpSumGrad.apply(t, sh.mesh)


def rand(shape, gen: Optional[torch.Generator], device) -> torch.Tensor:
    """torch.rand(shape) as the single-device step draws it: under an active
    RowShard, the full batch's draw, this rank's rows kept."""
    sh = current()
    if not _split_dp(sh):
        return torch.rand(shape, generator=gen, device=device)
    shape = tuple(shape)
    n_local = sh.rows.numel()
    if n_local == 0 or shape[0] % n_local:
        raise ValueError(f"draw of shape {shape} is not batch-major over "
                         f"{n_local} local rows")
    m = shape[0] // n_local
    full = torch.rand((sh.n_full * m,) + shape[1:], generator=gen, device=device)
    idx = sh.rows.to(full.device)[:, None] * m + torch.arange(m, device=full.device)
    return full[idx.reshape(-1)]


def dp_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a partial sum over this rank's rows) summed over "dp"."""
    sh = current()
    if not _split_dp(sh):
        return t
    return AllReduceSum.apply(t, sh.mesh.comm, sh.mesh.dp_group, "sum")


class _DpMax(torch.autograd.Function):
    """max over "dp" of the local maxima; the cotangent (summed over the
    ranks, whose uses differ) is shared evenly by every entry at the
    maximum on any rank, as torch.max shares it between ties."""

    @staticmethod
    def forward(ctx, t, mesh):
        gmax = mesh.comm.all_reduce(t.max(), mesh.dp_group, "max")
        hit = t == gmax
        count = mesh.comm.all_reduce(hit.sum().to(t.dtype), mesh.dp_group)
        ctx.mesh = mesh
        ctx.save_for_backward(hit, count)
        return gmax

    @staticmethod
    def backward(ctx, g):
        hit, count = ctx.saved_tensors
        g = ctx.mesh.comm.all_reduce(g, ctx.mesh.dp_group)
        return torch.where(hit, g / count, 0.0), None


def dp_max(t: torch.Tensor) -> torch.Tensor:
    """torch.max(t) over the whole chunk."""
    sh = current()
    if not _split_dp(sh):
        return torch.max(t)
    return _DpMax.apply(t, sh.mesh)


class _DpColSums(torch.autograd.Function):
    """out[p, b, k] = sum of vals[p] over every entry of the chunk, on any
    rank, whose id is ids[b, k]: a dense (P, n_nodes + 1) scatter, summed
    over "dp", read back at the ids.  Linear and self-adjoint."""

    @staticmethod
    def forward(ctx, vals, ids, n_nodes, mesh):
        ctx.ids, ctx.n_nodes, ctx.mesh = ids, n_nodes, mesh
        return _DpColSums._map(vals, ids, n_nodes, mesh)

    @staticmethod
    def _map(vals, ids, n_nodes, mesh):
        p = vals.shape[0]
        # (n_nodes + 1, P) sums in the segment sum's fixed order
        dense = segment_sum_by(vals.reshape(p, -1).T, ids, n_nodes + 1)
        dense = mesh.comm.all_reduce(dense, mesh.dp_group)
        return dense[ids].T.reshape(vals.shape)

    @staticmethod
    def backward(ctx, g):
        return (_DpColSums._map(g.contiguous(), ctx.ids, ctx.n_nodes, ctx.mesh),
                None, None, None)


def dp_col_sums(vals: torch.Tensor, ids: torch.Tensor,
                n_nodes: int) -> Optional[torch.Tensor]:
    """Per-entry column sums of the (P, B, K) planes over the whole chunk
    under an active RowShard that splits rows; None otherwise (the caller
    takes its local route).  ``ids``: the (B*K,) flat ids, sentinel n_nodes
    on empty lanes."""
    sh = current()
    if not _split_dp(sh):
        return None
    return _DpColSums.apply(vals, ids, n_nodes, sh.mesh)


def row_parallel(weight: torch.Tensor, bias: Optional[torch.Tensor],
                 x: torch.Tensor) -> Optional[torch.Tensor]:
    """x @ weight.T + bias for an ``x`` that holds this rank's tp share of
    the weight's input columns; None when ``x`` is full width or no tp
    shard is active."""
    sh = current()
    if sh is None or sh.mesh.tp == 1 or x.shape[-1] == weight.shape[1]:
        return None
    tp, t, w = sh.mesh.tp, sh.mesh.tp_rank, x.shape[-1]
    if w * tp != weight.shape[1]:
        raise ValueError(f"row-parallel input of width {w} for a weight of "
                         f"{weight.shape[1]} inputs over tp={tp}")
    sh.row_parallel.add(id(weight))
    part = F.linear(x, weight[:, t * w:(t + 1) * w])
    out = AllReduceSum.apply(part, sh.mesh.comm, sh.mesh.tp_group, "identity")
    return out if bias is None else out + bias

"""Full-graph sparse matrix x dense matrix products (the encoder's hot loop).

Port of ocn_tpu/ops/spmm.py: segment reductions over the COO view of the
graph.  Messages are ``val[p] * x[col[p]]`` summed into ``row[p]``.

* ``mean`` divides by the count of entries with val != 0 (DropAdj and
  maskinput shrink the denominator, as the reference's masked nnz do);
* ``max`` reduces val * x over present entries, empty rows give 0.

The sum SpMM over a symmetric pattern has a custom backward that re-indexes
through the transpose permutation ``tpos``, so dx is another row-sorted
segment sum of the same shape as the forward.  Past ``_SPMM_BLOCK_BYTES`` of
(E, H) intermediate the edge dimension is processed in blocks.

A node-sharded graph (parallel/sharded_graph.py LocalGraph) carries its own
halo-exchange ``sharded_spmm`` and convs; ``spmm``, ``gcn_norm_conv`` and
``gcn_selfloop_conv`` dispatch to them, so the encoder runs unchanged on a
shard.
"""
from __future__ import annotations

import torch

from ocn_tpu_torch.sparse.csr import Graph

# (E, H) message tensors above this many bytes are computed in edge blocks
_SPMM_BLOCK_BYTES = 1 << 31  # 2 GB


def _nblocks(nbytes: int) -> int:
    return max(1, -(-nbytes // _SPMM_BLOCK_BYTES))


def _segment_spmm(x, col, row, val, n_nodes):
    """sum_p val[p] * x[col[p]] into rows, edge-blocked past the budget."""
    e, h = col.shape[0], x.shape[-1]
    dtype = torch.promote_types(x.dtype, val.dtype)
    out = torch.zeros(n_nodes, h, dtype=dtype, device=x.device)
    nblk = _nblocks(e * h * dtype.itemsize)
    blk = -(-e // nblk)
    for s in range(0, e, blk):
        msg = val[s:s + blk, None] * x[col[s:s + blk]]
        out.index_add_(0, row[s:s + blk], msg)
    return out


def _edge_dots(x, dout, col, row):
    """dval[p] = <x[col[p]], dout[row[p]]>, blocked: two (E, H) gathered
    operands live at once, so the per-block budget is halved."""
    e, h = col.shape[0], x.shape[-1]
    itemsize = torch.promote_types(x.dtype, dout.dtype).itemsize
    nblk = _nblocks(2 * e * h * itemsize)
    blk = -(-e // nblk)
    return torch.cat([
        (x[col[s:s + blk]] * dout[row[s:s + blk]]).sum(-1)
        for s in range(0, e, blk)
    ]) if e else x.new_zeros(0)


class _SpmmSumSym(torch.autograd.Function):
    """Sum-SpMM with the transpose-permutation backward (_spmm_sum_sym):

        dx[k]   = sum_{q: row[q]==k} val[tpos[q]] * dout[col[q]]
        dval[p] = <x[col[p]], dout[row[p]]>
    """

    @staticmethod
    def forward(ctx, x, val, col, row, tpos, n_nodes):
        ctx.save_for_backward(x, val, col, row, tpos)
        return _segment_spmm(x, col, row, val, n_nodes)

    @staticmethod
    def backward(ctx, dout):
        x, val, col, row, tpos = ctx.saved_tensors
        dx = dval = None
        if ctx.needs_input_grad[0]:
            dx = _segment_spmm(dout, col, row, val[tpos], x.shape[0]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dval = _edge_dots(x, dout, col, row).to(val.dtype)
        return dx, dval, None, None, None, None


def _spmm_sum(g: Graph, x: torch.Tensor) -> torch.Tensor:
    if g.tpos is not None:
        return _SpmmSumSym.apply(x, g.val, g.col, g.row, g.tpos, g.n_nodes)
    return _segment_spmm(x, g.col, g.row, g.val, g.n_nodes)


def spmm(g: Graph, x: torch.Tensor, aggr: str = "sum") -> torch.Tensor:
    """aggr over in-neighbors: out[u] = aggr_{(u,v) in E} val * x[v]."""
    own = getattr(g, "sharded_spmm", None)
    if own is not None:
        return own(x, aggr)
    if aggr == "sum":
        return _spmm_sum(g, x)
    if aggr == "mean":
        s = _spmm_sum(g, x)
        cnt = torch.zeros(g.n_nodes, dtype=x.dtype, device=x.device)
        cnt.index_add_(0, g.row, (g.val != 0).to(x.dtype))
        return s / cnt.clamp_min(1.0)[:, None]
    if aggr == "max":
        neg = torch.finfo(x.dtype).min
        msg = g.val[:, None] * x[g.col]
        masked = torch.where((g.val != 0)[:, None], msg, neg)
        m = torch.full((g.n_nodes, x.shape[-1]), neg, dtype=x.dtype, device=x.device)
        m = m.scatter_reduce(0, g.row.long()[:, None].expand_as(masked), masked,
                             reduce="amax")
        # empty segments stay at the fill; torch_scatter zero-fills them
        return torch.where(m <= neg, 0.0, m)
    raise ValueError(f"unknown aggr {aggr!r}")


def gcn_norm_conv(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """PureConv 'gcn' aggregation: norm = rsqrt(1 + rowsum(A));
    out = norm * (A @ (norm * x) + norm * x)."""
    own = getattr(g, "gcn_norm_conv", None)
    if own is not None:
        return own(x)
    norm = torch.rsqrt(1.0 + g.value_rowsum()).to(x.dtype)[:, None]
    xn = norm * x
    return norm * (spmm(g, xn, "sum") + xn)


def gcn_selfloop_conv(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """PyG GCNConv propagation D^-1/2 (A + I) D^-1/2 with degrees from
    (A + I) row sums of values."""
    own = getattr(g, "gcn_selfloop_conv", None)
    if own is not None:
        return own(x)
    norm = torch.rsqrt(g.value_rowsum() + 1.0).to(x.dtype)[:, None]
    xn = norm * x
    return norm * (spmm(g, xn, "sum") + xn)

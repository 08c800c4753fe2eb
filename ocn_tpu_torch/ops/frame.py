"""Candidate-frame common-neighbor extraction (port of ocn_tpu/ops/frame.py:
the frames of the frame-based predictors cn1 and cn5-cn9).

For a batch of target edges (i, j) the candidate common neighbors are the
degree-capped, padded-to-K neighbor list of i.  Every CN matrix of the
batch then shares one index array ``ids`` (B, K) int32 (sentinel n_nodes on
empty lanes) and differs only in its value array (B, K):

    cn1.val[b, k] = w_i[b,k] * [ids[b,k] in N(j_b)]
    cn2.val[b, k] = w_i[b,k] * [A^2[j_b, ids[b,k]] > 0]

where w_i is the degree-cap importance weight (deg/K for capped rows), and
A^2[j, k] is read from precomputed capped rows ("gather" mode) or counted
on the fly as |N(k) & N(j)| ("sddmm" mode).
Entries with value 0 are absent, so masked adjacency entries drop out by
value.  The membership lookups run through ops/membership.py and the
window-table frame matmul through ops/window_gather.py (the CUDA kernels on
the card).

cn6's third frame (``cn3_frame``) reads a precomputed A^3 the same way,
and the incomplete family (cn2/cn3/cn4) takes the CN set with its two
residual sets from ``cn_residual_frames``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ocn_tpu_torch.ops import window_gather as W
from ocn_tpu_torch.ops.membership import membership_counts
from ocn_tpu_torch.parallel import shard
from ocn_tpu_torch.sparse.csr import Graph


@dataclasses.dataclass(frozen=True)
class NeighborFrame:
    """Padded, per-row-sorted neighbor lists for a batch of nodes.

    ids : (B, K) int32 neighbor ids, ascending per row; invalid lanes hold
          the sentinel ``n_nodes``.
    w   : (B, K) float32 entry weights: 0 for invalid/masked lanes, 1 for
          exact lanes, deg/K for degree-capped rows.
    pos : (B, K) CSR positions the ids were read from.
    """

    ids: torch.Tensor
    w: torch.Tensor
    n_nodes: int
    pos: Optional[torch.Tensor] = None

    @property
    def k(self) -> int:
        return self.ids.shape[-1]


def gather_neighbors(g: Graph, nodes: torch.Tensor, k: int,
                     gen: Optional[torch.Generator] = None,
                     drop: Optional[Tuple[torch.Generator, float]] = None,
                     sampling: str = "window") -> NeighborFrame:
    """The (<=k)-padded neighbor list of each node.

    Rows with degree <= k are taken exactly; capped rows (degree > k) get
    importance weight deg/k.  ``sampling="window"`` (the trainer's): a
    capped row takes a contiguous window of k entries at a uniform offset
    drawn from ``gen`` (the first k entries when ``gen`` is None).
    ``sampling="iid"`` (the reference's with-replacement draw, kept for
    parity experiments; the trainer never selects it): each lane of a
    capped row draws its entry independently, offset min(floor(u*deg),
    deg-1) for a (B, k) uniform u from ``gen``, and each row's lanes are
    then sorted by id (empty and masked lanes hold the sentinel n_nodes);
    with ``gen`` None it falls back to "window".  Adjacency values multiply
    the weights, so masked entries drop out by value.

    With an ELL table attached (``g.ell``, sparse/ell.py), "window"
    sampling and k <= ell_k the windows come from the table, one row
    gather: their offsets were frozen when the table was built, so ``gen``
    is ignored, and k < ell_k takes the leading lanes of the frozen window.

    ``drop=(gen, p)``: lane-mask DropAdj.  Each gathered lane is kept with
    probability 1-p (one (B, k) uniform draw of that generator, after the
    window offsets) and kept weights are scaled by 1/(1-p); the graph's
    values stay as they are, so its packed and ELL layouts stay attached.

    A graph that carries its own ``sharded_gather`` (a node-sharded window
    table, parallel/sharded_graph.py LocalWindows) answers through it."""
    own = getattr(g, "sharded_gather", None)
    if own is not None:
        return own(nodes, k, gen)
    if drop is not None:
        frame = gather_neighbors(g, nodes, k, gen, sampling=sampling)
        dgen, p = drop
        keep = shard.rand(frame.w.shape, dgen, frame.w.device) < 1.0 - p
        return dataclasses.replace(
            frame, w=torch.where(keep, frame.w * (1.0 / (1.0 - p)), 0.0))
    nodes = nodes.long()
    deg = g.deg[nodes]
    start = g.indptr[nodes]
    b = nodes.shape[0]
    lane = torch.arange(k, dtype=torch.int32, device=nodes.device)[None, :]
    capped = deg > k
    w_row = torch.where(capped, deg.float() / k, 1.0)
    valid = lane < torch.clamp(deg, max=k)[:, None]
    if g.ell is not None and sampling == "window" and k <= g.ell_k:
        pk = g.ell[nodes]
        if k < g.ell_k:
            pk = pk[:, :k]
        ids = pk & ((1 << g.col_bits) - 1)
        w = torch.where(valid, w_row[:, None] * (pk >> g.col_bits).float(), 0.0)
        ids = torch.where(valid, ids, g.n_nodes).int()
        pos0 = torch.clamp(start + g.ell_off[nodes], max=max(g.nnz - k, 0))
        return NeighborFrame(ids=ids, w=w, n_nodes=g.n_nodes,
                             pos=pos0[:, None] + lane)
    if sampling == "iid" and gen is not None:
        return _gather_iid(g, nodes, k, gen, deg, start, capped, w_row, valid)
    if gen is not None:
        u = shard.rand((b,), gen, nodes.device)
        woff = torch.where(capped, (u * (deg - k + 1).float()).int(), 0)
    else:
        woff = torch.zeros_like(deg)
    pos0 = torch.clamp(start + woff, max=max(g.nnz - k, 0))
    pos = pos0[:, None] + lane
    ids, vals = _entries(g, pos)
    w = torch.where(valid, w_row[:, None] * vals, 0.0)
    # invalid suffix lanes read into the next CSR row; sentinel-ize them so
    # rows stay ascending for the searchsorted membership branch
    ids = torch.where(valid, ids, g.n_nodes).int()
    return NeighborFrame(ids=ids, w=w, n_nodes=g.n_nodes, pos=pos)


def _entries(g: Graph, pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column ids and values of the CSR entries at ``pos``: one read of
    the packed col|count layout where the graph has it."""
    flat = pos.long()
    if g.packed is not None:
        pk = g.packed[flat]
        return pk & ((1 << g.col_bits) - 1), (pk >> g.col_bits).float()
    return g.col[flat], g.val[flat]


def _gather_iid(g: Graph, nodes, k, gen, deg, start, capped, w_row, valid
                ) -> NeighborFrame:
    """gather_neighbors' with-replacement draw: exact lanes for uncapped
    rows, min(floor(u*deg), deg-1) offsets for capped ones, lanes sorted
    by id."""
    lane = torch.arange(k, dtype=torch.int32, device=nodes.device)[None, :]
    exact_off = torch.minimum(lane, torch.clamp(deg, min=1)[:, None] - 1)
    u = shard.rand((nodes.shape[0], k), gen, nodes.device)
    samp_off = torch.minimum((u * deg[:, None].float()).int(), deg[:, None] - 1)
    off = torch.where(capped[:, None], samp_off, exact_off)
    pos = torch.clamp(start[:, None] + off, max=g.nnz - 1)
    ids, vals = _entries(g, pos)
    w = torch.where(valid, w_row[:, None] * vals, 0.0)
    ids = torch.where(valid & (vals != 0), ids, g.n_nodes).int()
    # ascending rows for the searchsorted membership branch
    ids, order = torch.sort(ids, dim=-1, stable=True)
    return NeighborFrame(ids=ids, w=torch.gather(w, -1, order), n_nodes=g.n_nodes,
                         pos=torch.gather(pos, -1, order))


# above this Kq*Ks product the O(Kq*Ks) compare stops paying for itself
_COMPARE_LIMIT = 32768


def _rowwise_membership(query_ids: torch.Tensor, sorted_ids: torch.Tensor,
                        sorted_w: torch.Tensor) -> torch.Tensor:
    """For each query id, the weight of the matching entry of the sorted row
    (0 if absent).  query (..., Kq), sorted (..., Ks) -> (..., Kq).

    * Kq*Ks <= _COMPARE_LIMIT: the compare-and-sum (ops/membership.py, the
      CUDA kernel on the card); duplicate ids add their weights;
    * otherwise: a row-wise binary search, which keeps only the FIRST
      matching entry of a row."""
    kq, ks = query_ids.shape[-1], sorted_ids.shape[-1]
    lead = torch.broadcast_shapes(query_ids.shape[:-1], sorted_ids.shape[:-1])
    q = query_ids.expand(lead + (kq,)).reshape(-1, kq)
    si = sorted_ids.expand(lead + (ks,)).reshape(-1, ks)
    sw = sorted_w.expand(lead + (ks,)).reshape(-1, ks)
    if kq * ks <= _COMPARE_LIMIT:
        out = membership_counts(q.int().contiguous(), si.int().contiguous(),
                                sw.float().contiguous())
        return out.reshape(lead + (kq,))
    idx = torch.searchsorted(si.contiguous(), q.contiguous()).clamp_(max=ks - 1)
    hit = torch.gather(si, 1, idx) == q
    wq = torch.gather(sw, 1, idx)
    return torch.where(hit, wq, 0.0).reshape(lead + (kq,))


@dataclasses.dataclass(frozen=True)
class CNFrame:
    """A batch of CN incidence matrices in the shared candidate frame: the
    sparse (B, n_nodes) matrix with entries (ids[b, k], val[b, k]) where
    val != 0."""

    ids: torch.Tensor  # (B, K) int32, sentinel n_nodes on empty lanes
    val: torch.Tensor  # (B, K) float32, 0 == absent
    n_nodes: int

    @property
    def mask(self) -> torch.Tensor:
        return self.val != 0

    def with_values(self, val: torch.Tensor) -> "CNFrame":
        return dataclasses.replace(self, val=val)

    def col_sum(self) -> torch.Tensor:
        """Per-node column sums over the batch (the whole chunk in the mesh
        step), (n_nodes,)."""
        s = torch.zeros(self.n_nodes + 1, dtype=self.val.dtype, device=self.val.device)
        s = s.index_add(0, self.ids.reshape(-1), self.val.reshape(-1))
        return shard.dp_sum(s)[: self.n_nodes]

    def scale_cols(self, colscale: torch.Tensor) -> "CNFrame":
        """Multiply each entry by a per-node factor (sentinel lanes have
        val == 0, so the clamped gather is harmless)."""
        safe = colscale[torch.clamp(self.ids, max=self.n_nodes - 1)]
        return self.with_values(self.val * safe)

    def inner(self, other: "CNFrame") -> torch.Tensor:
        """Sum of elementwise products over the shared pattern (the whole
        chunk in the mesh step)."""
        return shard.dp_sum(torch.sum(self.val * other.val))

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """cn @ x for this frame alone; its ids need not be sorted (the
        backward sorts them)."""
        return matmul_shared([self], x)[0]


@dataclasses.dataclass(frozen=True)
class FrameIndex:
    """Sorted-domain index of one chunk's flat candidate ids, shared by
    every column sum and frame matmul of the chunk.

    perm     : (M,) stable argsort of the flat ids
    rank     : (M,) compact column index per sorted position (0..U-1)
    seg      : (M,) sorted ids clamped to n_nodes-1 (frame-matmul dx rows)
    rank_inv : (M,) compact column index per entry (rank at the entry's
               sorted position)
    ids      : (M,) the flat ids (sentinel n_nodes kept)
    """

    perm: torch.Tensor
    rank: torch.Tensor
    seg: torch.Tensor
    rank_inv: torch.Tensor
    ids: torch.Tensor
    n_nodes: int


def frame_index(ids: torch.Tensor, n_nodes: int) -> FrameIndex:
    """Build the shared sorted-domain index for a (B, K) id array."""
    flat = ids.reshape(-1)
    perm = torch.argsort(flat, stable=True)
    sorted_ids = flat[perm]
    is_start = torch.ones_like(perm)
    is_start[1:] = (sorted_ids[1:] != sorted_ids[:-1]).long()
    rank = torch.cumsum(is_start, 0) - 1
    seg = torch.clamp(sorted_ids, max=n_nodes - 1).long()
    rank_inv = torch.empty_like(rank).index_copy_(0, perm, rank)
    return FrameIndex(perm, rank, seg, rank_inv, flat, n_nodes)


def _col_sum_map(vals: torch.Tensor, perm, rank, out_idx) -> torch.Tensor:
    """out[p, b, k] = sum of vals[p] over entries sharing ids[b, k]."""
    p = vals.shape[0]
    m = vals[0].numel()
    sv = vals.reshape(p, -1)[:, perm].T  # (M, P)
    sums = torch.zeros(m, p, dtype=vals.dtype, device=vals.device)
    sums.index_add_(0, rank, sv)
    return sums[out_idx].T.reshape(vals.shape)


class _EntryColSumMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, perm, rank, out_idx):
        ctx.save_for_backward(perm, rank, out_idx)
        return _col_sum_map(vals, perm, rank, out_idx)

    @staticmethod
    def backward(ctx, g):
        # linear and self-adjoint (the matrix [id_p == id_q] is symmetric)
        perm, rank, out_idx = ctx.saved_tensors
        return _col_sum_map(g, perm, rank, out_idx), None, None, None


def entry_col_sum_multi(vals: torch.Tensor, perm, rank, out_idx) -> torch.Tensor:
    """Per-entry batch column sums of P value planes sharing one id array:
    vals (P, B, K) -> (P, B, K), out[p, b, k] = sum over entries with id
    ids[b, k] of vals[p].  One sorted segment-sum pass; the VJP is the same
    map applied to the cotangent."""
    return _EntryColSumMulti.apply(vals, perm, rank, out_idx)


def entry_col_sums(vals: torch.Tensor, fidx: FrameIndex) -> torch.Tensor:
    """entry_col_sum_multi over the FrameIndex of the planes' ids; in the
    mesh step the sums run over the whole chunk, every rank's rows
    (parallel/shard.py dp_col_sums)."""
    out = shard.dp_col_sums(vals, fidx.ids, fidx.n_nodes)
    if out is not None:
        return out
    return entry_col_sum_multi(vals, fidx.perm, fidx.rank, fidx.rank_inv)


def _segment_dx(vals, dout, perm, seg, n_nodes: int) -> torch.Tensor:
    """dx of a frame matmul: sum_p vals[p] * dout[p] per entry, summed into
    its node by the sorted segment-sum over the FrameIndex (perm, seg)."""
    _, b, k = vals.shape
    coef = torch.einsum("pbk,pbh->bkh", vals, dout)
    contrib = coef.reshape(b * k, -1)[perm]
    return torch.zeros(n_nodes, dout.shape[-1], dtype=dout.dtype,
                       device=dout.device).index_add_(0, seg, contrib)


class _FrameMatmulMulti(torch.autograd.Function):
    """out[p, b] = sum_k vals[p, b, k] * x[ids[b, k]] over ONE row gather.

    Backward: dx = sorted segment-sum of sum_p vals[p]*dout[p] over the flat
    ids (reusing the FrameIndex sort when given, else sorting here);
    dvals[p, b, k] = <x[ids[b, k]], dout[p, b]>.  ``save_rows`` keeps the
    forward's (B, K, H) gather for the backward instead of re-gathering
    (the reference's default, _use_save_rows)."""

    @staticmethod
    def forward(ctx, x, vals, ids, perm, seg, n_nodes, save_rows):
        rows = x[torch.clamp(ids, max=n_nodes - 1)]  # (B, K, H)
        out = torch.einsum("pbk,bkh->pbh", vals, rows)
        ctx.n_nodes = n_nodes
        ctx.save_rows = save_rows
        ctx.save_for_backward(rows if save_rows else x, vals, ids, perm, seg)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved, vals, ids, perm, seg = ctx.saved_tensors
        n_nodes = ctx.n_nodes
        dx = dvals = None
        if ctx.needs_input_grad[0]:
            if perm.numel() == 0:
                flat = torch.clamp(ids, max=n_nodes - 1).reshape(-1)
                perm = torch.argsort(flat, stable=True)
                seg = flat[perm].long()
            dx = _segment_dx(vals, dout, perm, seg, n_nodes)
        if ctx.needs_input_grad[1]:
            rows = saved if ctx.save_rows else saved[torch.clamp(ids, max=n_nodes - 1)]
            dvals = torch.einsum("bkh,pbh->pbk", rows, dout)
        return dx, dvals, None, None, None, None, None


class _FrameMatmulMultiWindow(torch.autograd.Function):
    """_FrameMatmulMulti with the rows read as contiguous windows of the
    hoisted table y = x.detach()[g.col]: the candidate ids of a chunk are
    contiguous CSR windows (pos[b, k] == pos[b, 0] + k), so the (B, K, H)
    row gather becomes B window copies (ops/window_gather.py, the CUDA
    kernel on the card).  The windows are J = K + SLACK rows from an aligned
    start; the value planes are shifted into that layout (pad_vals).

    Gradient: out depends on x only through y, and y is built from the
    detached x, so the whole cotangent flows to x here: dx is the sorted
    segment-sum over (perm, seg) of _FrameMatmulMulti; nothing flows to y.
    dvals (dead in cn5: the CN values reach no parameter) re-runs the window
    gather only when asked for and takes lanes k + off.  No rows are kept for
    the backward.  The contiguity of ``pos`` is checked on CPU tensors; on
    the card the check would cost a host sync per chunk."""

    @staticmethod
    def forward(ctx, x, y, pos, vals, perm, seg, n_nodes):
        k = pos.shape[-1]
        if pos.device.type == "cpu":
            lane = torch.arange(k, dtype=pos.dtype)
            if not torch.equal(pos, pos[:, :1] + lane):
                raise ValueError("window frame matmul needs contiguous windows: "
                                 "pos[b, k] == pos[b, 0] + k")
        rows, off = W.window_rows(y, pos[:, 0], k)  # (B, J, H)
        out = torch.einsum("pbj,bjh->pbh", W.pad_vals(vals, off, k + W.SLACK), rows)
        ctx.n_nodes = n_nodes
        ctx.save_for_backward(y, pos, vals, perm, seg)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, pos, vals, perm, seg = ctx.saved_tensors
        p, b, k = vals.shape
        dx = dvals = None
        if ctx.needs_input_grad[0]:
            dx = _segment_dx(vals, dout, perm, seg, ctx.n_nodes)
        if ctx.needs_input_grad[3]:
            rows, off = W.window_rows(y, pos[:, 0], k)
            dvals_pad = torch.einsum("bjh,pbh->pbj", rows, dout)
            klane = (torch.arange(k, device=off.device)[None, :]
                     + off.long()[:, None])
            dvals = torch.gather(dvals_pad, 2, klane[None].expand(p, b, k))
        return dx, None, None, dvals, None, None, None


def matmul_shared(frames: List[CNFrame], x: torch.Tensor,
                  fidx: Optional[FrameIndex] = None,
                  save_rows: bool = True, y: Optional[torch.Tensor] = None,
                  pos: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """cn @ x for several frames sharing one id array, one gather in all.

    ``y``/``pos``: the window-table path, y = x.detach()[g.col] built once
    per step and pos the frames' CSR window positions (needs ``fidx``; see
    _FrameMatmulMultiWindow)."""
    ids = frames[0].ids
    # in the mesh step x may be a tp column share of h: the values' cotangent
    # then sums over the tp ranks (parallel/shard.py)
    vals = shard.tp_contracted(torch.stack([f.val for f in frames]), x.shape[-1])
    if y is not None and pos is not None and fidx is not None:
        out = _FrameMatmulMultiWindow.apply(x, y, pos, vals, fidx.perm,
                                            fidx.seg, frames[0].n_nodes)
        return list(out.unbind(0))
    empty = ids.new_zeros(0, dtype=torch.long)
    perm, seg = (fidx.perm, fidx.seg) if fidx is not None else (empty, empty)
    out = _FrameMatmulMulti.apply(x, vals, ids, perm, seg, frames[0].n_nodes,
                                  save_rows)
    return list(out.unbind(0))


def _count2(g: Graph, cand: torch.Tensor, dst_ids: torch.Tensor,
            dst_w: torch.Tensor, k2: int,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """A^2[j, cand] on the fly: |N(cand) & N(j)|, weighted, for candidates
    (C, K) against the dst frame (C, K2) of j.  Each candidate's K2-capped
    neighbor list is looked up in N(j): (C, K*K2) queries against K2 ids.
    Sentinel candidates gather the last row; their lanes carry src.w == 0,
    so the caller zeroes them."""
    c, kk = cand.shape
    nbr = gather_neighbors(g, torch.clamp(cand, max=g.n_nodes - 1).reshape(-1),
                           k2, gen)
    m = _rowwise_membership(nbr.ids.reshape(c, kk * k2), dst_ids, dst_w)
    contrib = torch.where(m != 0, nbr.w.reshape(c, kk * k2), 0.0)
    return contrib.reshape(c, kk, k2).sum(-1)


def cn_frames(
    g: Graph,
    tar_ei: torch.Tensor,
    k: int,
    k2: Optional[int] = None,
    gen: Optional[torch.Generator] = None,
    adj2: Optional[Graph] = None,
    self_corr: Optional[torch.Tensor] = None,
    k2_dst: Optional[int] = None,
    cn2_counts: bool = False,
    exact_two_hop: bool = False,
    with_src: bool = False,
    count2_chunk: int = 0,
):
    """cn1 and cn2 frames for target edges ``tar_ei`` (2, B); with
    ``with_src`` also the candidate frame N(i) itself (its CSR window
    positions feed the window-table frame matmul).

    cn1[b, k] != 0 iff candidate k is a 1-hop common neighbor of (i, j);
    cn2[b, k] != 0 iff candidate k is a neighbor of i with A^2[j, k] > 0
    (the path count itself with ``cn2_counts``; ``exact_two_hop`` drops
    1-hop neighbors of j).  ``k2`` caps N(j) and the two-hop lists.

    "gather" mode (``adj2`` given): A^2[j, k] is a membership lookup in the
    precomputed row-capped A^2, whose rows are k2 wide; ``k2_dst``, when
    set, caps N(j) instead of k2, since only cn1 reads it there.
    ``self_corr`` (B,): maskinput correction, subtracted from the counts
    because the removed target edge (i, j) still contributes one j-i-k path
    for every candidate k in N(i).

    "sddmm" mode (``adj2`` None): A^2[j, k] = |N(k) & N(j)| is counted on
    the masked ``g`` itself (so no self_corr), over k2-capped lists, in
    edge chunks of ``count2_chunk`` (0: one chunk) padded with sentinel
    rows; N(j) keeps k2 since it anchors the counts.

    Capped rows sample their window offsets from ``gen``: src, dst, then
    the A^2 rows or the candidates' lists."""
    k2 = k2 or k
    src = gather_neighbors(g, tar_ei[0], k, gen)
    kd = (k2_dst or k2) if adj2 is not None else k2
    dst = gather_neighbors(g, tar_ei[1], kd, gen)

    # cn1: membership of candidates (N(i)) in N(j)
    in_dst = _rowwise_membership(src.ids, dst.ids, dst.w)
    cn1_val = torch.where((in_dst != 0) & (src.w != 0), src.w, 0.0)
    cn1 = CNFrame(ids=src.ids, val=cn1_val, n_nodes=g.n_nodes)

    if adj2 is not None:
        # cn2: membership in the precomputed, row-capped A^2
        a2row = gather_neighbors(adj2, tar_ei[1], k2, gen)
        counts = _rowwise_membership(src.ids, a2row.ids, a2row.w)
        if self_corr is not None:
            counts = torch.clamp(counts - self_corr[:, None], min=0.0)
    else:
        b = src.ids.shape[0]
        cc = count2_chunk if 0 < count2_chunk < b else b
        pad = -b % cc
        ci = torch.nn.functional.pad(src.ids, (0, 0, 0, pad), value=g.n_nodes)
        di = torch.nn.functional.pad(dst.ids, (0, 0, 0, pad), value=g.n_nodes)
        dw = torch.nn.functional.pad(dst.w, (0, 0, 0, pad))
        counts = torch.cat([
            _count2(g, ci[s:s + cc], di[s:s + cc], dw[s:s + cc], k2, gen)
            for s in range(0, b + pad, cc)])[:b]
    if exact_two_hop:
        counts = torch.where(in_dst != 0, 0.0, counts)
    base = counts if cn2_counts else (counts > 0).float()
    cn2_val = torch.where(src.w != 0, src.w * base, 0.0)
    cn2 = CNFrame(ids=src.ids, val=cn2_val, n_nodes=g.n_nodes)
    return (cn1, cn2, src) if with_src else (cn1, cn2)


def cn3_frame(g: Graph, tar_ei: torch.Tensor, src: NeighborFrame, k2: int,
              k3: int, chunk: int = 256, counts: bool = False,
              adj3: Optional[Graph] = None) -> CNFrame:
    """3-hop CN frame on the candidate frame ``src`` (N(i)): cn3[b, k] != 0
    iff candidate k has A^3[j_b, k] > 0 (its path count with ``counts``).

    With ``adj3`` (the row-capped host A^3 = A^2 @ A): one row gather of A^3
    at j, k2 wide (from its ELL table when one is attached, else the first
    k2 entries of a capped row), and one membership lookup, as cn2 does
    against A^2.  A^3 gets no maskinput correction: third-order paths through
    the removed target edge are left in, as in the JAX package.

    Without it: A^3[j, k] = sum over m in N(k) of |N(m) & N(j)|, computed in
    chunks of ``chunk`` edges with caps k2 (candidate and dst lists) and k3
    (second-hop lists), first-k windows of capped rows; the test oracle."""
    if adj3 is not None:
        a3row = gather_neighbors(adj3, tar_ei[1], k2)
        counts3 = _rowwise_membership(src.ids, a3row.ids, a3row.w)
    else:
        b, k = src.ids.shape
        dstf = gather_neighbors(g, tar_ei[1], k2)
        # sentinel candidates gather the last row; their lanes carry weight 0
        cand = torch.clamp(src.ids, max=g.n_nodes - 1)
        parts = []
        for s in range(0, b, chunk):
            c = min(chunk, b - s)
            nbr = gather_neighbors(g, cand[s:s + c].reshape(-1), k2)
            nbr2 = gather_neighbors(
                g, torch.clamp(nbr.ids, max=g.n_nodes - 1).reshape(-1), k3)
            n2_ids = nbr2.ids.reshape(c, k * k2 * k3)
            n2_w = (nbr2.w.reshape(c, k, k2, k3)
                    * nbr.w.reshape(c, k, k2, 1)).reshape(c, k * k2 * k3)
            m = _rowwise_membership(n2_ids, dstf.ids[s:s + c], dstf.w[s:s + c])
            contrib = torch.where(m != 0, n2_w, 0.0)
            parts.append(contrib.reshape(c, k, k2 * k3).sum(-1))
        counts3 = torch.cat(parts)
    base = counts3 if counts else (counts3 > 0).float()
    val = torch.where(src.w != 0, src.w * base, 0.0)
    return CNFrame(ids=src.ids, val=val, n_nodes=g.n_nodes)


def cn_residual_frames(g: Graph, tar_ei: torch.Tensor, k: int,
                       gen: Optional[torch.Generator] = None,
                       drop: Optional[Tuple[torch.Generator, float]] = None,
                       with_src: bool = False):
    """The CN set and both residual sets of target edges (i, j), for the
    incomplete-CN predictors:

        cn   = N(i) & N(j)   (on the src frame N(i))
        res1 = N(i) \\ N(j)   (on the src frame)
        res2 = N(j) \\ N(i)   (on the dst frame N(j))

    ``with_src`` also returns the src NeighborFrame (cn3 builds its two-hop
    frames on its ids).  Capped rows draw their window offsets from ``gen``
    (src, then dst); ``drop=(gen, p)`` applies lane-mask DropAdj to each
    frame, the src and dst masks drawn independently (src first)."""
    src = gather_neighbors(g, tar_ei[0], k, gen, drop=drop)
    dst = gather_neighbors(g, tar_ei[1], k, gen, drop=drop)
    in_dst = _rowwise_membership(src.ids, dst.ids, dst.w)
    in_src = _rowwise_membership(dst.ids, src.ids, src.w)
    cn = CNFrame(src.ids, torch.where(in_dst != 0, src.w, 0.0), g.n_nodes)
    res1 = CNFrame(src.ids, torch.where(in_dst == 0, src.w, 0.0), g.n_nodes)
    res2 = CNFrame(dst.ids, torch.where(in_src == 0, dst.w, 0.0), g.n_nodes)
    return (cn, res1, res2, src) if with_src else (cn, res1, res2)

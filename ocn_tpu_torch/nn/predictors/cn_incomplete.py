"""Incomplete-graph CN predictors cn2 / cn3 / cn4 (port of
ocn_tpu/nn/predictors/cn_incomplete.py; reference IncompleteCN1Predictor,
IncompleteCN1Predictorhighorder and the save-memory twin cn4, which is cn2).

Besides the CN set N(i) & N(j), take the residual sets res1 = N(i) \\ N(j)
and res2 = N(j) \\ N(i) (capped to trainresdeg/testresdeg lanes).  Each
residual entry (e, k) is a potential CN if the missing edge (j_e, k) (resp.
(i_e, k)) existed: those candidate edges are scored by this same predictor
one depth lower, without gradient, and their scores become probabilities
through the Bayes-odds clamp

    p0 = sigmoid(scale * (prob - offset));   p = alpha2 * pt*p0 / (pt*p0 + 1-p0)

(``pt`` learnable per edge with ``learnablept``: sigmoid(ptlin2(relu(
ptlin1(xij))))).  The residual entries are weighted by them and aggregated
with the CN set.  cn2 orthogonalizes res2 against the column-normalized res1
on their (disjoint) union, so the batch inner product is 0 and the EMA only
decays; cn3 also completes the two-hop CN set cn22 = N(i) & A^2(j), which it
Gram-Schmidt-projects against ncn1, and completes both orders.

A depth-1 recursion runs through the blocked scorer ``_blocked_depth0``:
each anchor's neighbor window is gathered once for its R candidates, which
ride a middle axis (its membership lookups get (B, R, K) ids with the
anchor's row broadcast over R).  Deeper recursion, cndeg > 0 and large
blocks on a graph without ELL tables take the generic route, a flat forward
over the B*R candidate edges.

Training mode comes in as an argument, not from the module: the recursion
keeps the caller's mode when ``recursion_train_mode`` (dropouts and DropAdj
active inside it, and cn3's EMA stepping on each recursive call, in the
JAX package's order) and scores in eval mode otherwise.  ``alpha2`` (the
JAX package's "sched" collection, ramped by Config.increasealpha) is a
buffer apart from the EMA's ``innerprod`` and ``n``.

Randomness: ``gen`` drives the dropouts and the DropAdj lane masks,
``sample`` the window offsets of capped rows and the residual resampling;
the trainer passes one generator for both in training, and at eval a fixed
one as ``sample`` when Config.eval_sampling.  A forward draws, in order:
the src and dst windows (each with its lane mask), the cndeg sample, the
residual resamples, then the recursions; cn3 draws its A^2 row after the
windows, and samples cn/cn22, res1/res2 and cn2res1/cn2res2 each pair from
one draw, as the JAX package does with one key.
"""
from __future__ import annotations

from typing import Optional

import torch

from ocn_tpu_torch.nn.mlp import CNAggMLP, Dense, HeadMLP, XijMLP, XLin
from ocn_tpu_torch.nn.predictors.cn_ortho import _FramePredictor
from ocn_tpu_torch.ops.frame import (
    CNFrame, _rowwise_membership, cn_residual_frames, frame_index,
    gather_neighbors, matmul_shared)
from ocn_tpu_torch.ops.ortho import colnorm_plain, colnorm_quirk
from ocn_tpu_torch.ops.sample import sample_frame, sample_frames
from ocn_tpu_torch.ops.segment_sum import segment_sum_by, sort_segments
from ocn_tpu_torch.parallel import shard
from ocn_tpu_torch.sparse.csr import Graph

# a block of B*R candidate edges at frame width K goes blocked on a graph
# without ELL tables only while B*R*K stays under this
_BLOCK_FOOTPRINT = 2 ** 22


class IncompleteCNPredictor(_FramePredictor):
    """cn2/cn4, and cn3 with ``higher_order``.  Builds its own CN and
    residual frames from (g, tar_ei)."""

    def __init__(self, in_channels: int, hidden: int, out: int = 1,
                 dropout: float = 0.3, edrop: float = 0.0, ln: bool = False,
                 cndeg: int = -1, use_xlin: bool = False, tailact: bool = False,
                 twolayerlin: bool = False, beta_init: float = 1.0,
                 alpha_init: float = 1.0, scale: float = 5.0,
                 offset: float = 3.0, trainresdeg: int = 8,
                 testresdeg: int = 128, pt: float = 0.5,
                 learnablept: bool = False, depth: int = 1, k: int = 32,
                 rec_k: int = 0, higher_order: bool = False,
                 recursion_train_mode: bool = True, lane_drop: bool = True):
        super().__init__(beta_init, ema=True)
        self.edrop, self.cndeg, self.use_xlin = edrop, cndeg, use_xlin
        self.alpha_init, self.scale, self.offset = alpha_init, scale, offset
        self.trainresdeg, self.testresdeg = trainresdeg, testresdeg
        self.pt, self.learnablept, self.depth = pt, learnablept, depth
        self.k, self.rec_k, self.higher_order = k, rec_k, higher_order
        self.recursion_train_mode, self.lane_drop = recursion_train_mode, lane_drop
        self.register_buffer("alpha2", torch.tensor(float(alpha_init)))
        self.xijlin = XijMLP(in_channels, hidden, dropout, ln, tail_identity=tailact)
        if use_xlin:
            self.xlin = XLin(in_channels, hidden, dropout, ln)
        self.xcnlin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.head = HeadMLP(hidden, out, dropout, ln, twolayerlin)
        if learnablept:
            self.ptlin1 = Dense(hidden, hidden)
            self.ptlin2 = Dense(hidden, 1)

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        super().reset_parameters(gen)
        with torch.no_grad():
            self.alpha2.fill_(self.alpha_init)

    def forward(self, x: torch.Tensor, g: Graph, tar_ei: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                sample: Optional[torch.Generator] = None,
                adj2: Optional[Graph] = None,
                k: Optional[int] = None) -> torch.Tensor:
        """Scores (B, out) of the target edges (2, B) in the module's mode.
        ``k``: the outer frame width (the dual-K small body), default
        ``self.k``; the recursion keeps rec_k.  cn3 needs ``adj2``, the
        precomputed A^2."""
        return self._forward(x, g, tar_ei, self.training, self.depth, gen,
                             sample, adj2, k)

    def _forward(self, x, g, tar_ei, training, depth, gen, sample, adj2=None,
                 k=None):
        if self.higher_order:
            return self._forward_higher_order(x, g, tar_ei, training, depth,
                                              gen, sample, adj2, k)
        return self._forward_1hop(x, g, tar_ei, training, depth, gen, sample, k)

    # ------------------------------------------------------------- shared
    def _frame_width(self, depth: int, k: Optional[int]) -> int:
        # recursive calls (depth < self.depth) run at the recursion width
        if depth == self.depth:
            return k or self.k
        return self.rec_k or self.k

    def _drop(self, g: Graph, training: bool, gen):
        """(g, lane drop): lane masks on a packed graph, else the value-
        mutation DropAdj of the graph itself."""
        if not (training and self.edrop > 1e-6):
            return g, None
        if self.lane_drop and g.packed is not None:
            return g, (gen, self.edrop)
        return g.drop_edges(self.edrop, gen), None

    def _x_aug(self, x, training, gen):
        """x + xlin(x) over all nodes; in the mesh step x is this rank's tp
        column share and keeps it (parallel/shard.py)."""
        if not self.use_xlin:
            return x
        with shard.all_nodes():
            return x + shard.tp_columns(self.xlin(x, gen, training))

    def _ema_read(self) -> torch.Tensor:
        # a copy: later in-place steps of the buffer must not reach tensors
        # that autograd saved
        return self.innerprod.detach().clone()

    def _ema_step(self, value: torch.Tensor) -> None:
        with torch.no_grad():
            self.innerprod.copy_(value)
            self.n.add_(1)

    def _clamp(self, prob, xij):
        """The Bayes-odds clamp, with the learnable pt when asked for."""
        if self.learnablept:
            pt = torch.sigmoid(self.ptlin2(torch.relu(self.ptlin1(xij))))
        else:
            pt = self.pt
        p0 = torch.sigmoid(self.scale * (prob - self.offset))
        return self.alpha2 * pt * p0 / (pt * p0 + 1 - p0)

    def _blockable(self, g: Graph, res: CNFrame) -> bool:
        """Whether a depth-1 recursion block goes through the blocked scorer:
        never with cndeg > 0 (the sample would desync the shared ids), and on
        a graph without ELL tables only while the block's footprint
        B*R*K stays under 2^22."""
        if self.cndeg > 0:
            return False
        k_frame = self.rec_k or self.k
        return g.ell is not None or res.ids.numel() * k_frame <= _BLOCK_FOOTPRINT

    def _score_res(self, x, g, res: CNFrame, anchor, training, depth, gen,
                   sample, adj2, xij) -> CNFrame:
        """The residual frame ``res`` weighted by the clamped scores of its
        potential edges (anchor_e, k), scored one depth lower without
        gradient."""
        b, r = res.ids.shape
        rec_train = training and self.recursion_train_mode
        with torch.no_grad():
            if depth - 1 == 0 and self._blockable(g, res):
                prob = self._blocked_depth0(x, g, anchor, res.ids, rec_train,
                                            gen, sample, adj2, valid=res.mask)
            else:
                cand = torch.clamp(res.ids, max=g.n_nodes - 1).reshape(-1).long()
                anchors = anchor[:, None].expand(b, r).reshape(-1)
                prob = self._forward(x, g, torch.stack([anchors, cand]),
                                     rec_train, depth - 1, gen, sample,
                                     adj2).reshape(b, r)
        prob = self._clamp(prob, xij)
        return res.with_values(res.val * prob * res.mask)

    # ------------------------------------------------------------ cn2/cn4
    def _forward_1hop(self, x, g, tar_ei, training, depth, gen, sample, k):
        k_frame = self._frame_width(depth, k)
        g, drop = self._drop(g, training, gen)
        xij = self.xijlin(x[tar_ei[0]] * x[tar_ei[1]], gen, training)
        x_aug = self._x_aug(x, training, gen)
        resdeg = self.trainresdeg if training else self.testresdeg
        cn, res1, res2 = cn_residual_frames(g, tar_ei, k_frame, sample, drop=drop)
        if self.cndeg > 0:
            cn = sample_frame(cn, self.cndeg, sample)
        xcn = cn.matmul(x_aug)
        if depth > 0:
            if resdeg > 0:
                res1 = sample_frame(res1, resdeg, sample)
                res2 = sample_frame(res2, resdeg, sample)
            res1 = self._score_res(x, g, res1, tar_ei[1], training, depth, gen,
                                   sample, None, xij)
            res2 = self._score_res(x, g, res2, tar_ei[0], training, depth, gen,
                                   sample, None, xij)
            # res2 orthogonalized against ncn1 on the disjoint union: the
            # batch inner product is 0, so the EMA only decays
            ncn1 = colnorm_quirk(res1, 0.0)
            inner = self._ema_read()
            if training:
                inner = (1.0 - 1.0 / (self.n + 1).float()) * inner
                self._ema_step(inner)
            scale = shard.dp_max(torch.abs(ncn1.val))
            # inner / scale where scale > 0, else inner; the divisor is
            # replaced, not the quotient: with the learnable pt the values
            # carry a gradient, and a chunk whose probabilities all
            # underflow to 0 (scale 0, inner 0) would send 0 * (0/0) = NaN
            # back through a torch.where (and does in the JAX package)
            nip = inner / torch.where(scale > 0, scale, 1.0)
            union = CNFrame(ids=torch.cat([res2.ids, res1.ids], dim=-1),
                            val=torch.cat([res2.val, -nip * ncn1.val], dim=-1),
                            n_nodes=g.n_nodes)
            ocn2 = colnorm_plain(union)
            xcn = xcn + ocn2.matmul(x_aug) + ncn1.matmul(x_aug)
        z = self.xcnlin(xcn, gen, training)
        return self.head(z * self.beta + xij, gen, training)

    # --------------------------------------------------- blocked recursion
    def _blocked_depth0(self, x, g, anchors, cand_ids, training, gen, sample,
                        adj2, valid=None):
        """Depth-0 scores (B, R) of the candidate edges (anchors[b],
        cand_ids[b, r]), each anchor's neighbor window gathered once for its
        R candidates: the candidate axis rides in the middle, the membership
        lookups compare the anchor's row (broadcast over R) with each
        candidate's, and column sums pre-reduce over R.  DropAdj lane masks
        are drawn at (B, R, K), one per copy of the anchor's window.
        ``valid`` (B, R) masks padded candidates out of the cross-row state
        (column sums, EMA, scale)."""
        b, r = cand_ids.shape
        n = g.n_nodes
        k_frame = self.rec_k or self.k
        cand = torch.clamp(cand_ids, max=n - 1).long()
        g, drop = self._drop(g, training, gen)
        xij = self.xijlin(x[anchors][:, None, :] * x[cand], gen, training)
        x_aug = self._x_aug(x, training, gen)

        src = gather_neighbors(g, anchors, k_frame, sample)
        srcw = src.w[:, None, :].expand(b, r, k_frame)
        if drop is not None:
            keep = shard.rand((b, r, k_frame), gen, srcw.device) < 1.0 - self.edrop
            srcw = torch.where(keep, srcw * (1.0 / (1.0 - self.edrop)), 0.0)
        dstf = gather_neighbors(g, cand.reshape(-1), k_frame, sample, drop=drop)
        in_dst = _rowwise_membership(src.ids[:, None, :],
                                     dstf.ids.reshape(b, r, k_frame),
                                     dstf.w.reshape(b, r, k_frame))
        cn_val = torch.where(in_dst != 0, srcw, 0.0)
        if valid is not None:
            cn_val = cn_val * valid[:, :, None]
        xg = x_aug[torch.clamp(src.ids, max=n - 1)]  # (B, K, H): one gather

        def agg(val):
            return torch.einsum("brk,bkh->brh", val, xg)

        if not self.higher_order:
            z = self.xcnlin(agg(cn_val), gen, training)
            return self.head(z * self.beta + xij, gen, training).reshape(b, r)

        a2 = gather_neighbors(adj2, cand.reshape(-1), k_frame, sample)
        in_a2 = _rowwise_membership(src.ids[:, None, :],
                                    a2.ids.reshape(b, r, k_frame),
                                    a2.w.reshape(b, r, k_frame))
        cn22_val = torch.where(in_a2 != 0, srcw, 0.0)
        if valid is not None:
            cn22_val = cn22_val * valid[:, :, None]
        ids_flat = src.ids.reshape(-1).long()
        order = sort_segments(ids_flat, n + 1)

        def colsum(val_brk):
            # colsum is linear, and the R copies of an anchor share its ids
            pre = val_brk.sum(dim=1).reshape(-1)
            return shard.dp_sum(segment_sum_by(pre, ids_flat, n + 1, order))

        s1 = colsum(cn_val)
        s_rep = torch.where(s1 == 0, 1.0, s1)
        inv1 = torch.where(s_rep != 1, 1.0 / s_rep, 1.0)  # the fill=1 quirk
        ncn1_val = cn_val * inv1[ids_flat].reshape(b, 1, k_frame)
        ema_v = self._ema_read()
        if training:
            bet = 1.0 / (self.n + 1).float()
            ema_v = (1.0 - bet) * ema_v + bet * shard.dp_sum(
                torch.sum(cn22_val * ncn1_val))
            self._ema_step(ema_v)
        scale = shard.dp_max(torch.abs(ncn1_val))
        nip = torch.where(scale > 0, ema_v / scale, ema_v)
        mask_u = (cn22_val != 0) | (ncn1_val != 0)
        val_o = torch.where(mask_u, cn22_val - nip * ncn1_val, 0.0)
        s2 = colsum(val_o)
        inv2 = 1.0 / torch.where(s2 == 0, 1.0, s2)
        ncn22_val = val_o * inv2[ids_flat].reshape(b, 1, k_frame)
        z = (self.xcnlin(agg(ncn1_val), gen, training) * self.beta
             + self.xcnlin(agg(ncn22_val), gen, training) * self.beta)
        return self.head(z + xij, gen, training).reshape(b, r)

    # ---------------------------------------------------------------- cn3
    def _forward_higher_order(self, x, g, tar_ei, training, depth, gen,
                              sample, adj2, k):
        """cn3: also the two-hop CN set cn22 = N(i) & A^2(j), on the SAME src
        frame as cn and res1 (one id array: lane-aligned Gram-Schmidt, one
        shared frame index and matmul gather), with ncn1 filled with 1 on
        columns summing to 1, cn22 projected against ncn1 and renormalized,
        and residual completion of both orders (the residuals are not
        orthogonalized)."""
        if adj2 is None:
            raise ValueError("cn3 needs the precomputed A^2 (two_hop_mode='gather')")
        k_frame = self._frame_width(depth, k)
        g, drop = self._drop(g, training, gen)
        xij = self.xijlin(x[tar_ei[0]] * x[tar_ei[1]], gen, training)
        x_aug = self._x_aug(x, training, gen)
        resdeg = self.trainresdeg if training else self.testresdeg

        cn, res1, res2, srcf = cn_residual_frames(g, tar_ei, k_frame, sample,
                                                  drop=drop, with_src=True)
        # the A^2 row of j keeps the full width at the outer depth even under
        # a dual-K k: A^2 rows are fat whatever the 1-hop degree
        k_a2 = self.k if depth == self.depth else k_frame
        a2row = gather_neighbors(adj2, tar_ei[1], k_a2, sample)
        in_a2 = _rowwise_membership(srcf.ids, a2row.ids, a2row.w)
        in_src = _rowwise_membership(a2row.ids, srcf.ids, srcf.w)
        n = g.n_nodes
        cn22 = CNFrame(srcf.ids, torch.where(in_a2 != 0, srcf.w, 0.0), n)
        cn2res1 = CNFrame(srcf.ids, torch.where(in_a2 == 0, srcf.w, 0.0), n)
        cn2res2 = CNFrame(a2row.ids, torch.where(
            in_src == 0, (a2row.w != 0).float(), 0.0), n)
        share_src = self.cndeg <= 0
        if not share_src:
            cn, cn22 = sample_frames([cn, cn22], self.cndeg, sample)

        fidx = frame_index(srcf.ids, n) if share_src else None
        ncn1 = colnorm_quirk(cn, 1.0, fidx)
        inner = self._ema_read()
        if training:
            bet = 1.0 / (self.n + 1).float()
            inner = (1.0 - bet) * inner + bet * cn22.inner(ncn1)
            self._ema_step(inner)
        scale = shard.dp_max(torch.abs(ncn1.val))
        nip = torch.where(scale > 0, inner / scale, inner)
        ncn22 = colnorm_plain(cn22.with_values(torch.where(
            cn22.mask | ncn1.mask, cn22.val - nip * ncn1.val, 0.0)), fidx)
        if share_src:
            xcn_1, xcn_2 = matmul_shared([ncn1, ncn22], x_aug, fidx)
        else:
            xcn_1, xcn_2 = ncn1.matmul(x_aug), ncn22.matmul(x_aug)

        if depth > 0:
            if resdeg > 0:
                res1, res2 = sample_frames([res1, res2], resdeg, sample)
                cn2res1, cn2res2 = sample_frames([cn2res1, cn2res2], resdeg, sample)
            args = (training, depth, gen, sample, adj2, xij)
            res1 = self._score_res(x, g, res1, tar_ei[1], *args)
            res2 = self._score_res(x, g, res2, tar_ei[0], *args)
            cn2res1 = self._score_res(x, g, cn2res1, tar_ei[1], *args)
            cn2res2 = self._score_res(x, g, cn2res2, tar_ei[0], *args)
            xcn_1 = xcn_1 + res1.matmul(x_aug) + res2.matmul(x_aug)
            xcn_2 = xcn_2 + cn2res1.matmul(x_aug) + cn2res2.matmul(x_aug)

        z = (self.xcnlin(xcn_1, gen, training) * self.beta
             + self.xcnlin(xcn_2, gen, training) * self.beta)
        return self.head(z + xij, gen, training)

"""Orthogonalized-CN predictors: cn5 ("OCN") and cn1 (port of
ocn_tpu/nn/predictors/cn_ortho.py; reference CNLinkPredictorOringin and
CNLinkPredictor).

    column-normalize cn1 (quirk rule, empty columns filled with 0) -> EMA inner product <cn2, ncn1> ->
    Gram-Schmidt cn2 against ncn1 on the union pattern -> column-normalize
    -> aggregate -> MLPs -> head

cn5 aggregates node states, xcn = ncn @ h, through one shared gather (on the
window-table path, window copies of the hoisted table).  cn1 keeps the CN
rows "one-hot": the first Linear of each CN MLP is applied to the sparse
(B, n_nodes) rows (``OneHotMLP``), so its first weight is (n_nodes, hidden).

The EMA inner product (``innerprod``) and its counter (``n``) are buffers
that update only in training mode, once per call (= per link chunk).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ocn_tpu_torch.nn.mlp import (
    CNAggMLP, Dense, HeadMLP, XijMLP, _Seq, layer_norm, lecun_normal_,
    reset_parameters)
from ocn_tpu_torch.ops.frame import CNFrame, FrameIndex, frame_index, matmul_shared
from ocn_tpu_torch.ops.ortho import orthogonalize


class OneHotMLP(_Seq):
    """The CN MLP of cn1 and cn9 on one-hot CN rows: its first Linear is
    out[b] = sum_k val[b, k] * w1[ids[b, k]] + b1, a frame matmul with the
    (n_nodes, hidden) weight in place of the node states (which keeps only
    ids and values for the backward, whose dw1 is a sorted segment-sum);
    then Dropout, ReLU, Linear, LN?, Dropout, ReLU, Linear."""

    def __init__(self, n_nodes: int, hidden: int, dropout: float, ln: bool):
        super().__init__()
        self.p = dropout
        self.w1 = nn.Parameter(torch.empty(n_nodes, hidden))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.dense = nn.ModuleList(Dense(hidden, hidden) for _ in range(2))
        self.norm = nn.ModuleList([layer_norm(hidden)] if ln else [])
        self.plan = [("drop",), ("relu",), ("dense", 0)]
        self.plan += [("ln", 0)] if ln else []
        self.plan += [("drop",), ("relu",), ("dense", 1)]

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.w1, self.w1.shape[0], gen)
        nn.init.zeros_(self.b1)

    def forward(self, cn: CNFrame, fidx: FrameIndex,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        out = matmul_shared([cn], self.w1, fidx, save_rows=False)[0] + self.b1
        return super().forward(out, gen)


class _FramePredictor(nn.Module):
    """What the frame-based predictors share: ``beta`` and ``alpha``, and
    the EMA buffers for those that orthogonalize."""

    def __init__(self, beta_init: float, ema: bool):
        super().__init__()
        self.beta_init = beta_init
        self.beta = nn.Parameter(torch.full((1,), float(beta_init)))
        self.alpha = nn.Parameter(torch.ones(3))
        if ema:
            self.register_buffer("innerprod", torch.zeros(()))
            self.register_buffer("n", torch.zeros((), dtype=torch.int32))

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        reset_parameters(self, gen)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, OneHotMLP):
                m.reset_parameters(gen)
        with torch.no_grad():
            self.beta.fill_(self.beta_init)
            self.alpha.fill_(1.0)
            if hasattr(self, "innerprod"):
                self.innerprod.zero_()
                self.n.zero_()

    def _store_ema(self, new_ema: torch.Tensor, new_n: torch.Tensor) -> None:
        if self.training:
            with torch.no_grad():
                self.innerprod.copy_(new_ema)
                self.n.copy_(new_n)

    def _head(self, xcns, xij: torch.Tensor, gen) -> torch.Tensor:
        """lin(a0*xcn1 + a1*xcn2 [+ a2*xcn3] + beta*xij), a = cumprod of
        sigmoid(alpha)."""
        a = torch.cumprod(torch.sigmoid(self.alpha), 0)
        z = a[0] * xcns[0]
        for i in range(1, len(xcns)):
            z = z + a[i] * xcns[i]
        return self.lin(z + self.beta * xij, gen)


class OCNPredictor(_FramePredictor):
    """cn5 (reference CNLinkPredictorOringin)."""

    def __init__(self, in_channels: int, hidden: int, out: int = 1,
                 dropout: float = 0.3, edrop: float = 0.0, ln: bool = False,
                 cndeg: int = -1, use_xlin: bool = False, tailact: bool = False,
                 twolayerlin: bool = False, beta_init: float = 1.0):
        super().__init__(beta_init, ema=True)
        # edrop, cndeg and use_xlin are accepted for flag parity; cn5's
        # forward reads none of them (as in the reference)
        # created in the flax module's order: XijMLP_0, CNAggMLP_0/1, HeadMLP_0
        self.xijlin = XijMLP(in_channels, hidden, dropout, ln, tail_identity=tailact)
        self.xcn1lin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.xcn2lin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.lin = HeadMLP(hidden, out, dropout, ln, twolayerlin)

    def forward(self, x: torch.Tensor, n_nodes: int, cn1: CNFrame, cn2: CNFrame,
                tar_ei: torch.Tensor, gen: Optional[torch.Generator] = None,
                y: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``y``/``pos``: the window-table path (ops/frame.py matmul_shared),
        the hoisted table y = x.detach()[g.col] and the candidate frame's
        CSR window positions."""
        fidx = frame_index(cn1.ids, n_nodes)
        ncn1, ocn2, new_ema, new_n = orthogonalize(
            cn1, cn2, self.innerprod, self.n, self.training, 0.0, fidx)
        self._store_ema(new_ema, new_n)
        xcn1, xcn2 = matmul_shared([ncn1, ocn2], x, fidx, y=y, pos=pos)
        xij = self.xijlin(x[tar_ei[0]] * x[tar_ei[1]], gen)
        xcn1 = self.xcn1lin(xcn1, gen)
        xcn2 = self.xcn2lin(xcn2, gen)
        return self._head([xcn1, xcn2], xij, gen)


class CN1Predictor(_FramePredictor):
    """cn1 (reference CNLinkPredictor): cn5's orthogonalization, with one-hot
    CN aggregates (``xcn1lin``/``xcn2lin`` are OneHotMLPs over n_nodes)."""

    # the flax module's inline layers, in creation order: Dense_0,
    # LayerNorm_0, Dense_1 belong to xcn1lin, Dense_2, LayerNorm_1, Dense_3
    # to xcn2lin (weights.py)
    onehot_blocks = ("xcn1lin", "xcn2lin")

    def __init__(self, in_channels: int, hidden: int, n_nodes: int, out: int = 1,
                 dropout: float = 0.3, edrop: float = 0.0, ln: bool = False,
                 cndeg: int = -1, use_xlin: bool = False, tailact: bool = False,
                 twolayerlin: bool = False, beta_init: float = 1.0):
        super().__init__(beta_init, ema=True)
        self.xcn1lin = OneHotMLP(n_nodes, hidden, dropout, ln)
        self.xcn2lin = OneHotMLP(n_nodes, hidden, dropout, ln)
        self.xijlin = XijMLP(in_channels, hidden, dropout, ln, tail_identity=tailact)
        self.lin = HeadMLP(hidden, out, dropout, ln, twolayerlin)

    def forward(self, x: torch.Tensor, n_nodes: int, cn1: CNFrame, cn2: CNFrame,
                tar_ei: torch.Tensor, gen: Optional[torch.Generator] = None,
                y: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``y``/``pos`` are accepted and ignored: the one-hot aggregates
        gather weight rows, not node states."""
        fidx = frame_index(cn1.ids, n_nodes)
        ncn1, ocn2, new_ema, new_n = orthogonalize(
            cn1, cn2, self.innerprod, self.n, self.training, 0.0, fidx)
        self._store_ema(new_ema, new_n)
        xcn1 = self.xcn1lin(ncn1, fidx, gen)
        xcn2 = self.xcn2lin(ocn2, fidx, gen)
        xij = self.xijlin(x[tar_ei[0]] * x[tar_ei[1]], gen)
        return self._head([xcn1, xcn2], xij, gen)

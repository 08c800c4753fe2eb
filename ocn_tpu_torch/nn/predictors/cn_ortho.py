"""cn5 / OCN predictor (port of ocn_tpu/nn/predictors/cn_ortho.py
OCNPredictor; reference CNLinkPredictorOringin).

    column-normalize cn1 (quirk rule, empty columns filled with 0) -> EMA inner product <cn2, ncn1> ->
    Gram-Schmidt cn2 against ncn1 on the union pattern -> column-normalize
    -> xcn = ncn @ h through one shared gather (on the window-table path,
    window copies of the hoisted table) -> MLPs -> head

The EMA inner product (``innerprod``) and its counter (``n``) are buffers
that update only in training mode, once per call (= per link chunk).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ocn_tpu_torch.nn.mlp import CNAggMLP, HeadMLP, XijMLP, reset_parameters
from ocn_tpu_torch.ops.frame import CNFrame, frame_index, matmul_shared
from ocn_tpu_torch.ops.ortho import orthogonalize


class OCNPredictor(nn.Module):
    def __init__(self, in_channels: int, hidden: int, out: int = 1,
                 dropout: float = 0.3, edrop: float = 0.0, ln: bool = False,
                 cndeg: int = -1, use_xlin: bool = False, tailact: bool = False,
                 twolayerlin: bool = False, beta_init: float = 1.0):
        super().__init__()
        # edrop, cndeg and use_xlin are accepted for flag parity; cn5's
        # forward reads none of them (as in the reference)
        self.beta_init = beta_init
        self.beta = nn.Parameter(torch.full((1,), float(beta_init)))
        self.alpha = nn.Parameter(torch.ones(3))
        self.register_buffer("innerprod", torch.zeros(()))
        self.register_buffer("n", torch.zeros((), dtype=torch.int32))
        # created in the flax module's order: XijMLP_0, CNAggMLP_0/1, HeadMLP_0
        self.xijlin = XijMLP(in_channels, hidden, dropout, ln, tail_identity=tailact)
        self.xcn1lin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.xcn2lin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.lin = HeadMLP(hidden, out, dropout, ln, twolayerlin)

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        reset_parameters(self, gen)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        with torch.no_grad():
            self.beta.fill_(self.beta_init)
            self.alpha.fill_(1.0)
            self.innerprod.zero_()
            self.n.zero_()

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
        if self.training:
            with torch.no_grad():
                self.innerprod.copy_(new_ema)
                self.n.copy_(new_n)
        xcn1, xcn2 = matmul_shared([ncn1, ocn2], x, fidx, y=y, pos=pos)
        xij = self.xijlin(x[tar_ei[0]] * x[tar_ei[1]], gen)
        xcn1 = self.xcn1lin(xcn1, gen)
        xcn2 = self.xcn2lin(xcn2, gen)
        a = torch.cumprod(torch.sigmoid(self.alpha), 0)
        z = a[0] * xcn1 + a[1] * xcn2 + self.beta * xij
        return self.lin(z, gen)

"""GNN encoder (port of ocn_tpu/nn/encoder.py GCNEncoder): the reference's
GCN ("ts" stack) and GCN2/GCN3 ("ho", the pygho stack), which differ only
in their conv registry (nn/conv.py make_conv) and in that GCN2/GCN3 build
DropAdj but never apply it: under "ho" ``edrop`` changes nothing.

* input path: integer features (ppa/ddi) -> Embedding(max_x+1, hidden) with
  orthogonal init + Dropout(dropout); else Dropout(xdp) and, for "pure"
  convs or num_layers == 0, Linear(in, hidden) + Dropout(dropout);
* conv stack: pure convs are hidden -> hidden with per-layer DropAdj(edrop)
  and a tail Dropout(tdp) after the last conv; non-pure convs are followed
  by [LN?, Dropout, ReLU] except after the final conv of a multi-layer
  stack;
* optional residual (when shapes match) and JumpingKnowledge with *raw*
  learned weights: x = sum_l jkparams[l] * x_l.

DropAdj ("ts" only) masks the graph's values per layer, drawing from the
generator.

Under Config.dtype="bfloat16" the node features arrive in bfloat16, as in
the JAX package: the xdp dropout scales them in bfloat16 (x / keep rounds
there, as flax's Dropout does), the first Dense computes in float32 (flax's
promotion, nn/mlp.py Dense), and every later stage and the output are
float32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ocn_tpu_torch.nn.conv import make_conv
from ocn_tpu_torch.nn.mlp import Dense, dropout, layer_norm, reset_parameters
from ocn_tpu_torch.sparse.csr import Graph


class GCNEncoder(nn.Module):
    def __init__(self, in_features: int, hidden: int, num_layers: int = 1,
                 dropout: float = 0.3, ln: bool = False, res: bool = False,
                 max_x: int = -1, conv_fn: str = "gcn", jk: bool = False,
                 edrop: float = 0.0, xdropout: float = 0.0,
                 taildropout: float = 0.0, noinputlin: bool = False,
                 stack: str = "ts"):
        super().__init__()
        self.hidden, self.num_layers = hidden, num_layers
        self.p, self.xp, self.tp, self.edrop = dropout, xdropout, taildropout, edrop
        self.ln, self.res, self.jk, self.max_x = ln, res, jk, max_x
        self.conv_fn = conv_fn
        self.apply_adjdrop = stack == "ts"
        self.pure = "pure" in conv_fn
        self.emb = nn.Embedding(max_x + 1, hidden) if max_x >= 0 else None
        self.inputlin = None
        width = hidden if max_x >= 0 else in_features
        if max_x < 0 and not noinputlin and (self.pure or num_layers == 0):
            self.inputlin = Dense(in_features, hidden)
            width = hidden
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        if num_layers == 0 or conv_fn == "none":
            self.jkparams = None
            return
        for i in range(num_layers):
            self.convs.append(make_conv(conv_fn, width, hidden, stack))
            width = hidden
            if not self.pure and ln and (i < num_layers - 1 or num_layers == 1):
                self.norms.append(layer_norm(hidden))
        self.jkparams = nn.Parameter(torch.empty(num_layers)) if jk else None
        self.reset_parameters()

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        reset_parameters(self, gen)
        for m in self.norms:
            m.reset_parameters()
        for conv in self.convs:
            if getattr(conv, "bias", None) is not None:
                nn.init.zeros_(conv.bias)
        with torch.no_grad():
            if self.emb is not None:
                nn.init.orthogonal_(self.emb.weight, generator=gen)
            if self.jkparams is not None:
                self.jkparams.normal_(0.0, 1.0, generator=gen)

    def forward(self, x: torch.Tensor, g: Graph,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        train = self.training
        if self.emb is not None:
            x = dropout(self.emb(x.long()), self.p, train, gen)
        else:
            x = dropout(x, self.xp, train, gen)
            if self.inputlin is not None:
                x = self.inputlin(x)
                if self.p > 1e-6:
                    x = dropout(x, self.p, train, gen)
        if self.num_layers == 0 or self.conv_fn == "none":
            return x
        jkx = []
        for i, conv in enumerate(self.convs):
            drop = train and self.apply_adjdrop and self.edrop > 1e-6
            gg = g.drop_edges(self.edrop, gen) if drop else g
            x1 = conv(x, gg)
            last = i == self.num_layers - 1
            if self.pure:
                if last:
                    x1 = dropout(x1, self.tp, train, gen)
            elif not last or self.num_layers == 1:
                if self.ln:
                    x1 = self.norms[i](x1)
                x1 = torch.relu(dropout(x1, self.p, train, gen))
            x = x1 + x if self.res and x1.shape[-1] == x.shape[-1] else x1
            if self.jk:
                jkx.append(x)
        if self.jk:
            x = (torch.stack(jkx, 0) * self.jkparams[:, None, None]).sum(0)
        return x

"""cn6, the 3-hop orthogonalized CN predictor (port of
ocn_tpu/nn/predictors/cn_3hop.py; reference CNLinkPredictor3hopCNs).

It takes cn1, cn2 and cn3 frames on the shared candidate frame and runs a
double Gram-Schmidt (ops/ortho.py orthogonalize3): cn2 off ncn1, then cn3
off ncn1 and ocn2, each renormalized; one frame matmul aggregates the three,
and the head reads a0*xcn1 + a1*xcn2 + a2*xcn3 + beta*xij.  The three inner
products share ONE pair of EMA buffers, stepped three times per training
call.
"""
from __future__ import annotations

from typing import Optional

import torch

from ocn_tpu_torch.nn.mlp import CNAggMLP, HeadMLP, XijMLP
from ocn_tpu_torch.nn.predictors.cn_ortho import _FramePredictor
from ocn_tpu_torch.ops.frame import CNFrame, frame_index, matmul_shared
from ocn_tpu_torch.ops.ortho import orthogonalize3


class OCN3HopPredictor(_FramePredictor):
    def __init__(self, in_channels: int, hidden: int, out: int = 1,
                 dropout: float = 0.3, edrop: float = 0.0, ln: bool = False,
                 cndeg: int = -1, use_xlin: bool = False, tailact: bool = False,
                 twolayerlin: bool = False, beta_init: float = 1.0):
        super().__init__(beta_init, ema=True)
        # created in the flax module's order: CNAggMLP_0/1/2, XijMLP_0,
        # HeadMLP_0
        self.xcn1lin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.xcn2lin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.xcn3lin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.xijlin = XijMLP(in_channels, hidden, dropout, ln, tail_identity=tailact)
        self.lin = HeadMLP(hidden, out, dropout, ln, twolayerlin)

    def forward(self, x: torch.Tensor, n_nodes: int, cn1: CNFrame, cn2: CNFrame,
                cn3: CNFrame, tar_ei: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                y: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``y``/``pos``: the window-table path, as in OCNPredictor."""
        fidx = frame_index(cn1.ids, n_nodes)
        ncn1, ocn2, ocn3, new_ema, new_n = orthogonalize3(
            cn1, cn2, cn3, self.innerprod, self.n, self.training, 0.0, fidx)
        self._store_ema(new_ema, new_n)
        a1, a2, a3 = matmul_shared([ncn1, ocn2, ocn3], x, fidx, y=y, pos=pos)
        xcns = [self.xcn1lin(a1, gen), self.xcn2lin(a2, gen),
                self.xcn3lin(a3, gen)]
        xij = self.xijlin(x[tar_ei[0]] * x[tar_ei[1]], gen)
        return self._head(xcns, xij, gen)

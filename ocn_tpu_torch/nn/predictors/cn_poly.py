"""Polynomial-basis CN predictors: cn7 ("OCNP"), cn8 and cn9 (port of
ocn_tpu/nn/predictors/cn_poly.py; reference CNLinkPredictorbaselearn,
CNLinkPredictorbaselearnablation and
CNLinkPredictorbaselearnablationwithoutx).

The basis is diag(T_p(linspace(-1, 1, N))) applied on the right of a CN
matrix, a per-column scaling by the basis value at the column's node id:
in the candidate frame, ``val *= basis[ids]``.

The reference's quirks are kept:

* cn7 quirk-normalizes cn1 with ``empty_fill`` (``Config.sum``) and applies
  the basis to the RAW cn2 (its normalized cn2 is discarded);
* cn8 normalizes neither frame;
* cn9 is cn7 with one-hot CN aggregates (cn_ortho.OneHotMLP, as cn1);
* none of the three has an EMA inner product.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ocn_tpu_torch.nn.mlp import CNAggMLP, HeadMLP, XijMLP
from ocn_tpu_torch.nn.predictors.cn_ortho import OneHotMLP, _FramePredictor
from ocn_tpu_torch.ops.frame import CNFrame, frame_index, matmul_shared
from ocn_tpu_torch.ops.ortho import colnorm_quirk


def _ipow(x: torch.Tensor, p: int) -> torch.Tensor:
    """x**p by repeated squaring, the float32 products XLA's integer_pow
    takes (torch.pow rounds differently, which T_10's coefficients of up to
    1280 magnify past 1e-4)."""
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p:
            x = x * x
    return acc


# Chebyshev T_0..T_10 in closed form (reference model.py:2958-2992)
CHEBYSHEV = (
    lambda x: torch.ones_like(x),
    lambda x: x,
    lambda x: 2 * _ipow(x, 2) - 1,
    lambda x: 4 * _ipow(x, 3) - 3 * x,
    lambda x: 8 * _ipow(x, 4) - 8 * _ipow(x, 2) + 1,
    lambda x: 16 * _ipow(x, 5) - 20 * _ipow(x, 3) + 5 * x,
    lambda x: 32 * _ipow(x, 6) - 48 * _ipow(x, 4) + 18 * _ipow(x, 2) - 1,
    lambda x: 64 * _ipow(x, 7) - 112 * _ipow(x, 5) + 56 * _ipow(x, 3) - 7 * x,
    lambda x: (128 * _ipow(x, 8) - 256 * _ipow(x, 6) + 160 * _ipow(x, 4)
               - 32 * _ipow(x, 2) + 1),
    lambda x: (256 * _ipow(x, 9) - 576 * _ipow(x, 7) + 432 * _ipow(x, 5)
               - 120 * _ipow(x, 3) + 9 * x),
    lambda x: (512 * _ipow(x, 10) - 1280 * _ipow(x, 8) + 1120 * _ipow(x, 6)
               - 400 * _ipow(x, 4) + 50 * _ipow(x, 2) - 1),
)


def chebyshev_basis(n_nodes: int, poly_index: int,
                    device=None) -> torch.Tensor:
    """T_p(linspace(-1, 1, n_nodes)) in float32, the diagonal of the
    reference's evaluate_polynomial.  torch's linspace may sit an ulp from
    jnp's, which the closed forms magnify (tests/test_torch_poly.py)."""
    if not 0 <= poly_index < len(CHEBYSHEV):
        raise ValueError(f"poly_index must be in [0, {len(CHEBYSHEV) - 1}]")
    return CHEBYSHEV[poly_index](torch.linspace(-1.0, 1.0, n_nodes, device=device))


def apply_basis(cn: CNFrame, basis: torch.Tensor) -> CNFrame:
    """cn @ diag(basis): a per-column scaling in the candidate frame."""
    return cn.scale_cols(basis)


class _PolyPredictor(_FramePredictor):
    """The basis of cn7, cn8 and cn9, built once per (n_nodes, device)."""

    def __init__(self, beta_init: float, empty_fill: float, poly_first: int,
                 poly_second: int):
        super().__init__(beta_init, ema=False)
        self.empty_fill = empty_fill
        self.poly = (poly_first, poly_second)
        self._bases: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}

    def _basis(self, n_nodes: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (n_nodes, str(device))
        if key not in self._bases:
            self._bases[key] = tuple(chebyshev_basis(n_nodes, p, device)
                                     for p in self.poly)
        return self._bases[key]

    def _frames(self, n_nodes: int, cn1: CNFrame, cn2: CNFrame,
                normalize_cn1: bool):
        """(c1, c2, fidx): cn1 quirk-normalized when asked, both frames
        scaled by their bases."""
        fidx = frame_index(cn1.ids, n_nodes)
        c1 = colnorm_quirk(cn1, self.empty_fill, fidx) if normalize_cn1 else cn1
        b1, b2 = self._basis(n_nodes, cn1.val.device)
        return apply_basis(c1, b1), apply_basis(cn2, b2), fidx


class OCNPPredictor(_PolyPredictor):
    """cn7, and cn8 with ``normalize_cn1=False``."""

    def __init__(self, in_channels: int, hidden: int, out: int = 1,
                 dropout: float = 0.3, edrop: float = 0.0, ln: bool = False,
                 cndeg: int = -1, use_xlin: bool = False, tailact: bool = False,
                 twolayerlin: bool = False, beta_init: float = 1.0,
                 empty_fill: float = 1.0, poly_first: int = 0,
                 poly_second: int = 0, normalize_cn1: bool = True):
        super().__init__(beta_init, empty_fill, poly_first, poly_second)
        self.normalize_cn1 = normalize_cn1
        # created in the flax module's order: CNAggMLP_0/1, XijMLP_0, HeadMLP_0
        self.xcn1lin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.xcn2lin = CNAggMLP(in_channels, hidden, dropout, ln)
        self.xijlin = XijMLP(in_channels, hidden, dropout, ln, tail_identity=tailact)
        self.lin = HeadMLP(hidden, out, dropout, ln, twolayerlin)

    def forward(self, x: torch.Tensor, n_nodes: int, cn1: CNFrame, cn2: CNFrame,
                tar_ei: torch.Tensor, gen: Optional[torch.Generator] = None,
                y: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``y``/``pos``: the window-table path, as in OCNPredictor."""
        c1, c2, fidx = self._frames(n_nodes, cn1, cn2, self.normalize_cn1)
        a1, a2 = matmul_shared([c1, c2], x, fidx, y=y, pos=pos)
        xcn1 = self.xcn1lin(a1, gen)
        xcn2 = self.xcn2lin(a2, gen)
        xij = self.xijlin(x[tar_ei[0]] * x[tar_ei[1]], gen)
        return self._head([xcn1, xcn2], xij, gen)


class CN9Predictor(_PolyPredictor):
    """cn9: cn7's frames through one-hot CN aggregates."""

    onehot_blocks = ("xcn1lin", "xcn2lin")

    def __init__(self, in_channels: int, hidden: int, n_nodes: int, out: int = 1,
                 dropout: float = 0.3, edrop: float = 0.0, ln: bool = False,
                 cndeg: int = -1, use_xlin: bool = False, tailact: bool = False,
                 twolayerlin: bool = False, beta_init: float = 1.0,
                 empty_fill: float = 1.0, poly_first: int = 0,
                 poly_second: int = 0):
        super().__init__(beta_init, empty_fill, poly_first, poly_second)
        self.xcn1lin = OneHotMLP(n_nodes, hidden, dropout, ln)
        self.xcn2lin = OneHotMLP(n_nodes, hidden, dropout, ln)
        self.xijlin = XijMLP(in_channels, hidden, dropout, ln, tail_identity=tailact)
        self.lin = HeadMLP(hidden, out, dropout, ln, twolayerlin)

    def forward(self, x: torch.Tensor, n_nodes: int, cn1: CNFrame, cn2: CNFrame,
                tar_ei: torch.Tensor, gen: Optional[torch.Generator] = None,
                y: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``y``/``pos`` are accepted and ignored (one-hot aggregates)."""
        c1, c2, fidx = self._frames(n_nodes, cn1, cn2, True)
        xcn1 = self.xcn1lin(c1, fidx, gen)
        xcn2 = self.xcn2lin(c2, fidx, gen)
        xij = self.xijlin(x[tar_ei[0]] * x[tar_ei[1]], gen)
        return self._head([xcn1, xcn2], xij, gen)

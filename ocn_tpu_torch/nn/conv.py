"""Graph convolutions (port of ocn_tpu/nn/conv.py), both conv registries.

The torch_sparse ("ts") stack:

* ``PureConv``: parameter-free aggregation mean/max/sum/gcn.
* ``GCNConvLike``: PyG-GCNConv-style conv with an internal Linear (no bias)
  and a separate bias, used by the non-"pure" names gcn/sage/gin/max;
  sage/gin/max are plain aggregation of xW plus bias.

The pygho ("ho") stack:

* ``PureConvV2``: PureConv for mean/max/sum; 'gcn' weights each edge by
  ``enorm = norm[i] * norm[j]`` with norm = rsqrt(1 + rowsum(A)) and adds
  no self term.
* ``LinConv``: PureConvV2, then Linear(bias=False) and ReLU, used by the
  non-"pure" names.
"""
from __future__ import annotations

import torch
from torch import nn

from ocn_tpu_torch.nn.mlp import Dense
from ocn_tpu_torch.ops.spmm import gcn_norm_conv, gcn_selfloop_conv, spmm
from ocn_tpu_torch.sparse.csr import Graph


class PureConv(nn.Module):
    """Parameter-free conv."""

    def __init__(self, aggr: str = "gcn"):
        super().__init__()
        if aggr not in ("mean", "max", "sum", "gcn"):
            raise ValueError(aggr)
        self.aggr = aggr

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        if self.aggr == "gcn":
            return gcn_norm_conv(g, x)
        return spmm(g, x, self.aggr)


class PureConvV2(PureConv):
    """The pygho pure conv: PureConv for mean/max/sum; 'gcn' is the sum
    SpMM over the edge weights val * norm[row] * norm[col], no self term.
    The weighted graph keeps the transpose permutation, so its backward is
    the transpose-permutation one: the weights are symmetric wherever the
    values are.  A node-sharded graph brings its own (``gcn_enorm_conv``:
    the remote norms arrive with the halo)."""

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        if self.aggr != "gcn":
            return spmm(g, x, self.aggr)
        own = getattr(g, "gcn_enorm_conv", None)
        if own is not None:
            return own(x)
        norm = torch.rsqrt(1.0 + g.value_rowsum()).to(x.dtype)
        gw = g.with_values(g.val * norm[g.row] * norm[g.col])
        return spmm(gw, x, "sum")


class GCNConvLike(nn.Module):
    """out = prop(A~, x W) + b, where prop is D^-1/2 (A+I) D^-1/2 when
    ``normalize``, else the raw aggregation."""

    def __init__(self, in_features: int, features: int, aggr: str = "sum",
                 normalize: bool = True):
        super().__init__()
        self.lin = Dense(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))
        self.aggr = aggr
        self.normalize = normalize

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        x = self.lin(x)
        out = gcn_selfloop_conv(g, x) if self.normalize else spmm(g, x, self.aggr)
        return out + self.bias


class LinConv(nn.Module):
    """relu(PureConvV2(aggr)(x) W): aggregation first, then a bias-free
    Linear and a ReLU."""

    def __init__(self, in_features: int, features: int, aggr: str = "gcn"):
        super().__init__()
        self.conv = PureConvV2(aggr)
        self.lin = Dense(in_features, features, bias=False)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        return torch.relu(self.lin(self.conv(x, g)))


_AGGR = {"gcn": "gcn", "gcn_cached": "gcn", "sage": "mean", "gin": "sum",
         "max": "max"}


def make_conv(name: str, in_features: int, features: int, stack: str = "ts"):
    """The conv registries: ``stack="ts"`` the torch_sparse one, ``"ho"``
    the pygho one (one registry serves the reference's GCN2 and GCN3, whose
    registries differ only in an autocast guard).  None for "none"."""
    if name == "none":
        return None
    if name.startswith("pure"):
        return (PureConv if stack == "ts" else PureConvV2)(name.removeprefix("pure"))
    aggr = _AGGR[name]
    if stack == "ts":
        return GCNConvLike(in_features, features, "sum" if aggr == "gcn" else aggr,
                           normalize=aggr == "gcn")
    return LinConv(in_features, features, aggr)


CONV_NAMES = (
    "gcn", "gcn_cached", "sage", "gin", "max",
    "puremax", "puresum", "puremean", "puregcn", "none",
)

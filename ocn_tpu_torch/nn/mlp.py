"""Predictor MLP vocabulary (port of ocn_tpu/nn/mlp.py), plus the dropout
and the initialisers the port's modules share.

Layers are created in the order the flax modules create theirs, so
``weights.params_from_jax`` maps ``Dense_i``/``LayerNorm_i`` one to one.
Dropout takes an explicit ``torch.Generator`` (torch semantics: train-time
scaling by 1/(1-p)) and is active only in training mode.  LayerNorm uses
eps 1e-5.  Parameters start from flax's defaults: LeCun-normal (truncated)
kernels, zero biases.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ocn_tpu_torch.parallel import shard


def dropout(x: torch.Tensor, p: float, training: bool,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``gen`` (in the mesh step, the
    single-device step's mask, parallel/shard.py)."""
    if not training or p <= 0.0:
        return x
    keep = shard.rand(x.shape, gen, x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal on [-2, 2] standard deviations,
    rescaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / max(fan_in, 1)) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen).mul_(std)


class Dense(nn.Linear):
    """nn.Linear with flax's default initialisation and flax's type rule:
    nn.Dense (dtype=None) promotes its input and its float32 kernel to a
    common type, so a bfloat16 input (the node features under
    Config.dtype="bfloat16") is computed on in float32 and everything after
    the first Dense is float32.  Given its tp column share of the input in
    the mesh step, it computes row-parallel (parallel/shard.py)."""

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.in_features, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        out = shard.row_parallel(self.weight, self.bias, x)
        return super().forward(x) if out is None else out


def layer_norm(n: int) -> nn.LayerNorm:
    return nn.LayerNorm(n, eps=1e-5)


class _Seq(nn.Module):
    """Shared forward for the Linear/LN/Dropout/ReLU stacks below: ``plan``
    lists ("dense", i) | ("ln", i) | ("drop",) | ("relu",) steps.
    ``training`` overrides the module's mode for the dropouts (the
    incomplete family's recursion may score in either mode)."""

    def forward(self, x, gen: Optional[torch.Generator] = None,
                training: Optional[bool] = None):
        training = self.training if training is None else training
        for step in self.plan:
            if step[0] == "dense":
                x = self.dense[step[1]](x)
            elif step[0] == "ln":
                x = self.norm[step[1]](x)
            elif step[0] == "drop":
                x = dropout(x, self.p, training, gen)
            else:
                x = torch.relu(x)
        return x


class CNAggMLP(_Seq):
    """xcnlin / xcn1lin / xcn2lin: Linear(in,h), Dropout, ReLU, Linear(h,h),
    LN?, Dropout, ReLU, Linear(h,h)."""

    def __init__(self, in_features: int, hidden: int, dropout: float, ln: bool):
        super().__init__()
        self.p = dropout
        self.dense = nn.ModuleList(
            Dense(in_features if i == 0 else hidden, hidden) for i in range(3))
        self.norm = nn.ModuleList([layer_norm(hidden)] if ln else [])
        self.plan = [("dense", 0), ("drop",), ("relu",), ("dense", 1)]
        self.plan += [("ln", 0)] if ln else []
        self.plan += [("drop",), ("relu",), ("dense", 2)]


class XijMLP(_Seq):
    """xijlin: Linear(in,h), LN?, Dropout, ReLU, [Linear(h,h) unless
    tail_identity]."""

    def __init__(self, in_features: int, hidden: int, dropout: float, ln: bool,
                 tail_identity: bool = False):
        super().__init__()
        self.p = dropout
        n_dense = 1 if tail_identity else 2
        self.dense = nn.ModuleList(
            Dense(in_features if i == 0 else hidden, hidden) for i in range(n_dense))
        self.norm = nn.ModuleList([layer_norm(hidden)] if ln else [])
        self.plan = [("dense", 0)] + ([("ln", 0)] if ln else [])
        self.plan += [("drop",), ("relu",)]
        self.plan += [] if tail_identity else [("dense", 1)]


class HeadMLP(_Seq):
    """lin: Linear(h,h), LN?, Dropout, ReLU, [second block if twolayer],
    Linear(h,out)."""

    def __init__(self, hidden: int, out: int, dropout: float, ln: bool,
                 twolayer: bool = False):
        super().__init__()
        self.p = dropout
        nblock = 2 if twolayer else 1
        self.dense = nn.ModuleList(
            Dense(hidden, out if i == nblock else hidden) for i in range(nblock + 1))
        self.norm = nn.ModuleList(layer_norm(hidden) for _ in range(nblock if ln else 0))
        self.plan = []
        for i in range(nblock):
            self.plan += [("dense", i)] + ([("ln", i)] if ln else [])
            self.plan += [("drop",), ("relu",)]
        self.plan += [("dense", nblock)]


class XLin(_Seq):
    """xlin (gated by use_xlin; cn5 builds no xlin): Linear, Dropout, ReLU,
    Linear, LN?, Dropout, ReLU."""

    def __init__(self, in_features: int, hidden: int, dropout: float, ln: bool):
        super().__init__()
        self.p = dropout
        self.dense = nn.ModuleList([Dense(in_features, hidden), Dense(hidden, hidden)])
        self.norm = nn.ModuleList([layer_norm(hidden)] if ln else [])
        self.plan = [("dense", 0), ("drop",), ("relu",), ("dense", 1)]
        self.plan += [("ln", 0)] if ln else []
        self.plan += [("drop",), ("relu",)]


def reset_parameters(module: nn.Module, gen: Optional[torch.Generator] = None) -> None:
    """Re-initialise every Dense in ``module`` from ``gen`` (LayerNorms and
    module-specific parameters are reset by their owners)."""
    for m in module.modules():
        if isinstance(m, Dense):
            m.reset_parameters(gen)

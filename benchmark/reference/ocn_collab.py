"""Plain reference of ``ocn_collab``: OCN (cn5) on collab, the command at
qingpingmo/OCN README.md:42 (a 1-layer GIN encoder with LayerNorm and JK;
column-normalised one-hop CN frame, the two-hop frame Gram-Schmidt
orthogonalised against it with a running mean of their inner product;
MLP heads).  Imports nothing of the measured program."""
from __future__ import annotations

from typing import Dict

import torch

from reference import _runs
from reference import _ocn as R


def params(p: Dict, m: Dict, f_in: int, gen: torch.Generator) -> None:
    """The encoder's, then the predictor's, in the program's draw order."""
    R.gin_params(p, m, f_in, gen)
    h = m["hiddim"]
    p["predictor.beta"] = torch.full((1,), float(m["beta"]))
    p["predictor.alpha"] = torch.ones(3)
    R.mlp_params(p, "xij", "predictor.xijlin", h, gen)
    R.mlp_params(p, "cn", "predictor.xcn1lin", h, gen)
    R.mlp_params(p, "cn", "predictor.xcn2lin", h, gen)
    R.mlp_params(p, "head", "predictor.lin", h, gen)


def predict(p: Dict, m: Dict, h: torch.Tensor, ids, v1, v2, edges, st: Dict,
            drop: R.Dropout, training: bool) -> torch.Tensor:
    """Scores of one chunk of links; advances the running inner product of
    the chunk in training."""
    n = h.shape[0]
    s1 = R.col_sums(ids, v1, n)
    s1 = torch.where(s1 == 0, 1.0, s1)
    n1 = v1 * torch.where(s1 != 1, 1.0 / s1, 0.0)
    if training:
        st["n"] += 1
        beta = 1.0 / torch.tensor(float(st["n"]), device=h.device)
        st["ema"] = (1.0 - beta) * st["ema"] + beta * torch.sum(v2 * n1)
    inner = st["ema"]
    scale = n1.abs().max()
    nip = torch.where(scale > 0, inner / scale, inner)
    vo = torch.where((v2 != 0) | (n1 != 0), v2 - nip * n1, 0.0)
    so = R.col_sums(ids, vo, n)
    o2 = vo * (1.0 / torch.where(so == 0, 1.0, so))
    xcn1, xcn2 = R.aggregate(torch.stack([n1, o2]), ids, h).unbind(0)
    rate = m["predp"]
    xij = R.xij_mlp(p, "predictor.xijlin", h[edges[0]] * h[edges[1]], drop, rate)
    xcn1 = R.cn_mlp(p, "predictor.xcn1lin", xcn1, drop, rate)
    xcn2 = R.cn_mlp(p, "predictor.xcn2lin", xcn2, drop, rate)
    return R.head(p, xcn1, xcn2, xij, drop, rate)


def train(cfg, data, seed, steps, device, tf32=False, fault="", epochs=1):
    return _runs.train(cfg, predict, params, data, seed, steps, device, tf32, fault,
                       epochs)


def evaluate(cfg, data, seed, device, tf32=False):
    return _runs.evaluate(cfg, predict, params, data, seed, device, tf32)

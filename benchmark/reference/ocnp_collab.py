"""Plain reference of ``ocnp_collab``: OCNP (cn7) on collab, the command at
qingpingmo/OCN README.md:81 (a 1-layer GIN encoder with LayerNorm; the
column-normalised one-hop CN frame and the raw two-hop frame, each scaled by
a Chebyshev polynomial of the node index, the basis; MLP heads).  Imports
nothing of the measured program."""
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
    R.mlp_params(p, "cn", "predictor.xcn1lin", h, gen)
    R.mlp_params(p, "cn", "predictor.xcn2lin", h, gen)
    R.mlp_params(p, "xij", "predictor.xijlin", h, gen)
    R.mlp_params(p, "head", "predictor.lin", h, gen)


def chebyshev(n: int, order: int, device) -> torch.Tensor:
    """T_order(linspace(-1, 1, n)) by the three-term recurrence."""
    x = torch.linspace(-1.0, 1.0, n, device=device)
    t0, t1 = torch.ones_like(x), x
    if order == 0:
        return t0
    for _ in range(order - 1):
        t0, t1 = t1, 2 * x * t1 - t0
    return t1


def predict(p: Dict, m: Dict, h: torch.Tensor, ids, v1, v2, edges, st: Dict,
            drop: R.Dropout, training: bool) -> torch.Tensor:
    """Scores of one chunk of links."""
    n = h.shape[0]
    s1 = R.col_sums(ids, v1, n)
    s1 = torch.where(s1 == 0, 1.0, s1)
    c1 = v1 * torch.where(s1 != 1, 1.0 / s1, float(m["sum"]))
    safe = torch.clamp(ids, max=n - 1)
    c1 = c1 * chebyshev(n, m["polyfirst"], h.device)[safe]
    c2 = v2 * chebyshev(n, m["polysecond"], h.device)[safe]
    a1, a2 = R.aggregate(torch.stack([c1, c2]), ids, h).unbind(0)
    rate = m["predp"]
    xcn1 = R.cn_mlp(p, "predictor.xcn1lin", a1, drop, rate)
    xcn2 = R.cn_mlp(p, "predictor.xcn2lin", a2, drop, rate)
    xij = R.xij_mlp(p, "predictor.xijlin", h[edges[0]] * h[edges[1]], drop, rate)
    return R.head(p, xcn1, xcn2, xij, drop, rate)


def train(cfg, data, seed, steps, device, tf32=False, fault="", epochs=1):
    return _runs.train(cfg, predict, params, data, seed, steps, device, tf32, fault,
                       epochs)


def evaluate(cfg, data, seed, device, tf32=False):
    return _runs.evaluate(cfg, predict, params, data, seed, device, tf32)

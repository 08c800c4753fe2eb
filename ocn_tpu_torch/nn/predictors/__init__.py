"""Predictor registry (port of ocn_tpu/nn/predictors/__init__.py).

Every predictor is ported: cn1 (``CN1Predictor``), cn5 (OCN,
``OCNPredictor``), cn6 (``OCN3HopPredictor``), cn7 and cn8
(``OCNPPredictor``, cn8 without cn1's normalization), cn9
(``CN9Predictor``), and the incomplete family, cn2 and cn4
(``IncompleteCNPredictor``; cn4, the reference's save-memory rewrite, is
cn2) and cn3 (``IncompleteCNPredictor(higher_order=True)``).  The
frame-based predictors take the CN frames that the trainer builds; the
self-building family builds its own from (graph, target edges).
"""
from __future__ import annotations

from typing import Any, Optional

from ocn_tpu_torch.nn.predictors.cn_3hop import OCN3HopPredictor
from ocn_tpu_torch.nn.predictors.cn_incomplete import IncompleteCNPredictor
from ocn_tpu_torch.nn.predictors.cn_ortho import CN1Predictor, OCNPredictor
from ocn_tpu_torch.nn.predictors.cn_poly import CN9Predictor, OCNPPredictor

PREDICTOR_NAMES = ("cn1", "cn2", "cn3", "cn4", "cn5", "cn6", "cn7", "cn8", "cn9")

# predictors that take prebuilt (cn1, cn2[, cn3]) frames from the driver
FRAME_BASED = {"cn1", "cn5", "cn6", "cn7", "cn8", "cn9"}
# predictors that need 3-hop frames as well
THREE_HOP = {"cn6"}
# predictors that build everything internally from (g, tar_ei)
SELF_BUILDING = {"cn2", "cn3", "cn4"}


def build_predictor(name: str, in_channels: int, hidden: int,
                    n_nodes: Optional[int] = None, **kw: Any):
    """Instantiate a predictor from CLI-style kwargs (Config.predictor_kwargs);
    cn1 and cn9 need ``n_nodes`` (their one-hot first layers)."""
    if name not in PREDICTOR_NAMES:
        raise KeyError(f"unknown predictor {name!r}; choose from {PREDICTOR_NAMES}")
    common = dict(
        in_channels=in_channels,
        hidden=hidden,
        out=kw.get("out", 1),
        dropout=kw.get("dropout", 0.3),
        edrop=kw.get("edrop", 0.0),
        ln=kw.get("ln", False),
        cndeg=kw.get("cndeg", -1),
        use_xlin=kw.get("use_xlin", False),
        tailact=kw.get("tailact", False),
        twolayerlin=kw.get("twolayerlin", False),
        beta_init=kw.get("beta", 1.0),
    )
    poly = dict(empty_fill=kw.get("sum", 1.0),
                poly_first=kw.get("polyfirst", 0),
                poly_second=kw.get("polysecond", 0))
    if name in ("cn1", "cn9") and n_nodes is None:
        raise ValueError(f"predictor {name!r} needs n_nodes")
    if name == "cn5":
        return OCNPredictor(**common)
    if name == "cn1":
        return CN1Predictor(n_nodes=n_nodes, **common)
    if name == "cn6":
        return OCN3HopPredictor(**common)
    if name in SELF_BUILDING:
        trndeg, tstdeg = kw.get("trndeg", -1), kw.get("tstdeg", -1)
        return IncompleteCNPredictor(
            higher_order=(name == "cn3"),
            alpha_init=kw.get("alpha", 1.0),
            scale=kw.get("probscale", 5.0),
            offset=kw.get("proboffset", 3.0),
            trainresdeg=trndeg if trndeg > 0 else 8,
            testresdeg=tstdeg if tstdeg > 0 else 128,
            pt=kw.get("pt", 0.5),
            learnablept=kw.get("learnpt", False),
            depth=kw.get("depth", 1),
            k=kw.get("k", 32),
            rec_k=kw.get("rec_k", 0),
            recursion_train_mode=kw.get("recursion_train_mode", True),
            lane_drop=kw.get("lane_dropadj", True),
            **common)
    if name in ("cn7", "cn8"):
        return OCNPPredictor(normalize_cn1=(name == "cn7"), **poly, **common)
    return CN9Predictor(n_nodes=n_nodes, **poly, **common)

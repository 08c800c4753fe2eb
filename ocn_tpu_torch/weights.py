"""Load the JAX package's parameters into the port's modules.

``params_from_jax(params, ema, encoder, predictor)`` takes ocn_tpu's
parameter tree (``TrainState.params``: ``{"encoder": ..., "predictor":
...}``) and EMA collection (``TrainState.ema``) as nested dicts of NumPy
arrays (``jax.device_get`` gives them) and copies them into a port
``GCNEncoder`` (either conv stack) and predictor (any of cn1-cn9),
including the EMA buffers where the predictor has them and the incomplete
family's "sched" state (``alpha2``).  Dense
kernels (in, out) are transposed into Linear weights (out, in); LayerNorm
``scale``/``bias`` become ``weight``/``bias``.  Every leaf of the tree must
land somewhere, and every shape must match: a mismatch raises.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _copy(dst: torch.Tensor, src, name: str, transpose: bool = False) -> None:
    arr = np.array(src)  # a writable copy (0-d arrays stay 0-d)
    if transpose:
        arr = arr.T.copy()
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {arr.shape} vs port {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.as_tensor(arr, dtype=dst.dtype))


def _load_dense(lin: nn.Linear, p: Mapping, name: str) -> None:
    _copy(lin.weight, p["kernel"], f"{name}.kernel", transpose=True)
    if "bias" in p:
        _copy(lin.bias, p["bias"], f"{name}.bias")


def _load_norm(norm: nn.LayerNorm, p: Mapping, name: str) -> None:
    _copy(norm.weight, p["scale"], f"{name}.scale")
    _copy(norm.bias, p["bias"], f"{name}.bias")


def _load_seq(mod: nn.Module, p: Mapping, name: str) -> None:
    """An mlp.py stack: Dense_i -> dense[i], LayerNorm_i -> norm[i]."""
    for key, sub in p.items():
        kind, _, i = key.rpartition("_")
        if kind == "Dense":
            _load_dense(mod.dense[int(i)], sub, f"{name}/{key}")
        elif kind == "LayerNorm":
            _load_norm(mod.norm[int(i)], sub, f"{name}/{key}")
        else:
            raise KeyError(f"unmapped JAX parameter {name}/{key}")


def load_encoder(enc: nn.Module, p: Mapping) -> None:
    for key, sub in p.items():
        kind, _, i = key.rpartition("_")
        if key == "jkparams":
            _copy(enc.jkparams, sub, "encoder/jkparams")
        elif kind == "GCNConvLike":
            conv = enc.convs[int(i)]
            _load_dense(conv.lin, sub["Dense_0"], f"encoder/{key}/Dense_0")
            _copy(conv.bias, sub["bias"], f"encoder/{key}/bias")
        elif kind == "LinConv":  # the "ho" stack; its PureConvV2 has none
            _load_dense(enc.convs[int(i)].lin, sub["Dense_0"],
                        f"encoder/{key}/Dense_0")
        elif kind == "LayerNorm":
            _load_norm(enc.norms[int(i)], sub, f"encoder/{key}")
        elif key == "Dense_0":
            _load_dense(enc.inputlin, sub, "encoder/Dense_0")
        elif key == "Embed_0":
            _copy(enc.emb.weight, sub["embedding"], "encoder/Embed_0")
        else:
            raise KeyError(f"unmapped JAX parameter encoder/{key}")


# flax names of the MLP blocks: auto-named in the frame-based predictors,
# named by attribute in the incomplete family's setup()
_PREDICTOR_BLOCKS = {"XijMLP_0": "xijlin", "CNAggMLP_0": "xcn1lin",
                     "CNAggMLP_1": "xcn2lin", "CNAggMLP_2": "xcn3lin",
                     "HeadMLP_0": "lin", "xijlin": "xijlin", "xlin": "xlin",
                     "xcnlin": "xcnlin", "head": "head"}


def _load_onehot_layer(pred: nn.Module, key: str, sub, kind: str, i: int) -> None:
    """cn1's and cn9's inline layers, numbered by one counter per kind over
    the one-hot blocks in order: Dense_0/1 and LayerNorm_0 belong to the
    first block, Dense_2/3 and LayerNorm_1 to the second."""
    per_block = 2 if kind == "Dense" else 1
    names = getattr(pred, "onehot_blocks", ())
    if i // per_block >= len(names):
        raise KeyError(f"unmapped JAX parameter predictor/{key}")
    block = getattr(pred, names[i // per_block])
    if kind == "Dense":
        _load_dense(block.dense[i % 2], sub, f"predictor/{key}")
    elif len(block.norm):
        _load_norm(block.norm[0], sub, f"predictor/{key}")
    else:
        raise KeyError(f"unmapped JAX parameter predictor/{key}")


def load_predictor(pred: nn.Module, p: Mapping, ema: Mapping,
                   sched: Optional[Mapping] = None) -> None:
    """Copy a predictor's parameters, EMA and sched state: the MLP blocks
    by their flax names, cn1's and cn9's one-hot weights (``xcn1_w1``,
    ``xcn1_b1``, ...) and inline layers, the incomplete family's ``ptlin1``/
    ``ptlin2`` and ``alpha2``.  Predictors without an EMA (cn7, cn8, cn9)
    take an empty ``ema``, all but the incomplete family an empty or no
    ``sched``."""
    for key, sub in p.items():
        kind, _, i = key.rpartition("_")
        if key in ("alpha", "beta"):
            _copy(getattr(pred, key), sub, f"predictor/{key}")
        elif key in _PREDICTOR_BLOCKS and hasattr(pred, _PREDICTOR_BLOCKS[key]):
            _load_seq(getattr(pred, _PREDICTOR_BLOCKS[key]), sub, f"predictor/{key}")
        elif key in ("ptlin1", "ptlin2") and hasattr(pred, key):
            _load_dense(getattr(pred, key), sub, f"predictor/{key}")
        elif key in ("xcn1_w1", "xcn1_b1", "xcn2_w1", "xcn2_b1"):
            block, _, leaf = key.partition("_")
            dst = getattr(getattr(pred, f"{block}lin"), leaf, None)
            if dst is None:
                raise KeyError(f"unmapped JAX parameter predictor/{key}")
            _copy(dst, sub, f"predictor/{key}")
        elif kind in ("Dense", "LayerNorm") and i.isdigit():
            _load_onehot_layer(pred, key, sub, kind, int(i))
        else:
            raise KeyError(f"unmapped JAX parameter predictor/{key}")
    if hasattr(pred, "innerprod"):
        _copy(pred.innerprod, ema["innerprod"], "ema/innerprod")
        _copy(pred.n, ema["n"], "ema/n")
    extra = set(ema) - ({"innerprod", "n"} if hasattr(pred, "innerprod") else set())
    if extra:
        raise KeyError(f"unmapped JAX EMA state {sorted(extra)}")
    sched = dict(sched or {})
    if hasattr(pred, "alpha2") and "alpha2" in sched:
        _copy(pred.alpha2, sched.pop("alpha2"), "sched/alpha2")
    if sched:
        raise KeyError(f"unmapped JAX sched state {sorted(sched)}")


def params_from_jax(params: Mapping, ema: Mapping, encoder: nn.Module,
                    predictor: nn.Module, sched: Optional[Mapping] = None
                    ) -> Tuple[nn.Module, nn.Module]:
    """Copy ocn_tpu parameters, EMA and sched state into (encoder,
    predictor); returns them."""
    load_encoder(encoder, params["encoder"])
    load_predictor(predictor, params["predictor"], ema, sched)
    return encoder, predictor

"""Load the JAX package's parameters into the port's modules.

``params_from_jax(params, ema, encoder, predictor)`` takes ocn_tpu's
parameter tree (``TrainState.params``: ``{"encoder": ..., "predictor":
...}``) and EMA collection (``TrainState.ema``) as nested dicts of NumPy
arrays (``jax.device_get`` gives them) and copies them into a port
``GCNEncoder`` (either conv stack) and predictor (any of cn1-cn9),
including the EMA buffers where the predictor has them and the incomplete
family's "sched" state (``alpha2``).  ``state_from_jax(jstate, state)``
carries a whole JAX ``TrainState`` across, the optimizer too: the optax
Adam moments and counts of both parameter groups (``optax.multi_transform``
over two ``optax.adam``) become ``torch.optim.Adam``'s ``exp_avg``,
``exp_avg_sq`` and ``step``, laid out as the parameters are, so a JAX run
can be continued by the port.  Dense
kernels (in, out) are transposed into Linear weights (out, in); LayerNorm
``scale``/``bias`` become ``weight``/``bias``.  Every leaf of the tree must
land somewhere, and every shape must match: a mismatch raises.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Optional, Tuple

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


def _find_adam(node):
    """The optax ``ScaleByAdamState`` inside one group's state (a
    ``MaskedState`` around the chain's tuple), found by its fields."""
    if all(hasattr(node, a) for a in ("count", "mu", "nu")):
        return node
    inner = getattr(node, "inner_state", node)
    if isinstance(inner, (tuple, list)):
        for child in inner:
            found = _find_adam(child)
            if found is not None:
                return found
    elif inner is not node:
        return _find_adam(inner)
    return None


def adam_groups(opt_state) -> Dict[str, Dict[str, object]]:
    """{"encoder": {"count", "mu", "nu"}, "predictor": {...}} from the JAX
    trainer's optimizer state: one ``optax.adam`` per group under
    ``optax.multi_transform``, whose moment trees hold the group's own
    subtree (the other is masked)."""
    out = {}
    for label, group in opt_state.inner_states.items():
        adam = _find_adam(group)
        if adam is None:
            raise KeyError(f"no Adam state in optimizer group {label!r}")
        out[label] = {"count": adam.count, "mu": adam.mu[label],
                      "nu": adam.nu[label]}
    return out


def _as_parameters(module: nn.Module, load, tree) -> List[torch.Tensor]:
    """A tree shaped like ``module``'s JAX parameters as tensors laid out
    like ``module.parameters()``: loaded into a copy of the module by the
    same mapping as its weights (transposed Dense kernels included)."""
    twin = copy.deepcopy(module)
    load(twin, tree)
    return [p.detach() for p in twin.parameters()]


def adam_from_jax(opt: torch.optim.Optimizer, encoder: nn.Module,
                  predictor: nn.Module, opt_state, ema: Mapping,
                  sched: Optional[Mapping] = None) -> None:
    """Set ``opt`` (the port's two-group Adam: encoder, then predictor)
    to the JAX optimizer state: each parameter's step is its group's optax
    count, its moments optax's mu and nu."""
    groups = adam_groups(opt_state)
    loaders = (("encoder", encoder, load_encoder),
               ("predictor", predictor,
                lambda m, t: load_predictor(m, t, ema, sched)))
    for group, (label, module, load) in zip(opt.param_groups, loaders):
        params = list(group["params"])
        if [id(p) for p in params] != [id(p) for p in module.parameters()]:
            raise ValueError(f"optimizer group {label!r} does not hold "
                             f"the {label}'s parameters in order")
        jg = groups[label]
        step = float(np.asarray(jg["count"]))
        mu = _as_parameters(module, load, jg["mu"])
        nu = _as_parameters(module, load, jg["nu"])
        for p, m, v in zip(params, mu, nu):
            # a capturable Adam (the card's) keeps its step on the device
            dev = p.device if opt.defaults.get("capturable") else "cpu"
            opt.state[p] = {"step": torch.tensor(step, dtype=torch.float32, device=dev),
                            "exp_avg": m.clone(), "exp_avg_sq": v.clone()}


def state_from_jax(jstate, state):
    """Carry a JAX ``TrainState`` (NumPy leaves, as ``jax.device_get``
    gives it) into the port's ``TrainState`` ``state``: parameters, EMA,
    sched and the Adam state; returns ``state``."""
    params_from_jax(jstate.params, jstate.ema, state.encoder, state.predictor,
                    jstate.sched)
    adam_from_jax(state.opt, state.encoder, state.predictor, jstate.opt_state,
                  jstate.ema, jstate.sched)
    return state


def tp_shard(tensors: Mapping[str, torch.Tensor], row_parallel, tp_rank: int,
             tp: int) -> Dict[str, torch.Tensor]:
    """One tp rank's shard of a full port state (a name -> tensor mapping,
    e.g. a module's state_dict): each row-parallel weight, (out, in), keeps
    its rank's block of input columns, the block the mesh step computes with
    (parallel/shard.py); every other tensor is whole on every rank.
    ``row_parallel``: the names of the row-parallel weights
    (Trainer.row_parallel_names)."""
    out = {}
    for name, t in tensors.items():
        if name in row_parallel:
            w = t.shape[1] // tp
            t = t[:, tp_rank * w:(tp_rank + 1) * w]
        out[name] = t.clone()
    return out


def tp_join(shards, row_parallel) -> Dict[str, torch.Tensor]:
    """The full state from the tp ranks' shards (tp_shard's inverse)."""
    return {name: torch.cat([s[name] for s in shards], dim=1)
            if name in row_parallel else t.clone()
            for name, t in shards[0].items()}

"""Checkpoints and embedding export (port of ocn_tpu/train/checkpoint.py).

``save_state(path, state, step)`` writes the whole ``TrainState``: the
encoder's and predictor's parameters and buffers (the EMA ``innerprod`` and
``n``, the incomplete family's ``alpha2``, the JAX package's "sched"
collection) and the two-group Adam state with its step counts, with
``torch.save`` into ``path/<step>/state.pt``, through a temporary file
renamed into place.  Every step is kept, as the JAX package's orbax
``CheckpointManager`` keeps them.  ``load_state(path, state, step=None)``
restores the latest step (or ``step``) into the tensors of ``state``, on
their device, and returns ``(state, step)``.

The JAX package's checkpoints are orbax directories; the port does not
read them.  A JAX ``TrainState`` carries across in memory instead
(weights.py ``state_from_jax``).

Embeddings (``save_embeddings``, ``load_embeddings``) are ``.npy`` files
written by ``np.save``, as in the JAX package, so a file from either
package loads in the other.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

_FILE = "state.pt"


def _steps(path: str):
    return sorted(int(name) for name in os.listdir(path)
                  if name.isdigit() and os.path.exists(os.path.join(path, name, _FILE)))


def save_state(path: str, state, step: int) -> None:
    step_dir = os.path.join(os.path.abspath(path), str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    out = os.path.join(step_dir, _FILE)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        torch.save({"encoder": state.encoder.state_dict(),
                    "predictor": state.predictor.state_dict(),
                    "opt": state.opt.state_dict(), "step": int(step)}, tmp)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_state(path: str, state, step: Optional[int] = None):
    """Restore the checkpoint at ``step`` (default: the latest) into
    ``state``'s modules and optimizer; returns (state, step)."""
    path = os.path.abspath(path)
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path}")
        step = steps[-1]
    saved = torch.load(os.path.join(path, str(int(step)), _FILE),
                       map_location="cpu", weights_only=True)
    state.encoder.load_state_dict(saved["encoder"])
    state.predictor.load_state_dict(saved["predictor"])
    # moves each Adam moment onto its parameter's device
    state.opt.load_state_dict(saved["opt"])
    return state, int(step)


def save_embeddings(path: str, h) -> None:
    """`--save_gemb` / `--savex`: one array as ``.npy``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(h, torch.Tensor):
        h = h.detach().cpu()
        # NumPy has no bfloat16
        h = (h.float() if h.dtype == torch.bfloat16 else h).numpy()
    np.save(path, np.asarray(h))


def load_embeddings(path: str) -> np.ndarray:
    return np.load(path)

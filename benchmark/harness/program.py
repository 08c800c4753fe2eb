"""The program side of a run: the port's dataset, Trainer and counters, built
from the benchmark's arrays and a configuration file.  Only the entries
import this module; the references never do."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


def program_config(cfg: Dict):
    """The port's Config of the preset the configuration names (with its
    ``overrides``, which the benchmark's own configurations leave empty), checked
    field by field against the configuration file's ``model`` block: a
    preset that no longer states the configuration stops the run."""
    from ocn_tpu_torch.config import Config, presets

    pc = presets(cfg["preset"]["dataset"], cfg["preset"]["predictor"],
                 **cfg.get("overrides", {}))
    fields = {f.name for f in dataclasses.fields(Config)}
    wrong = {k: (v, getattr(pc, k)) for k, v in cfg["model"].items()
             if k in fields and getattr(pc, k) != v}
    if wrong:
        raise ValueError(f"presets{tuple(cfg['preset'].values())} differs from "
                         f"{cfg['name']}.json (file, preset): {wrong}")
    return pc


def dataset(data: Dict, name: str, use_valedges: bool):
    """The port's LinkDataset of the run's arrays, relabelled in BFS order
    as its command-line entry does."""
    from ocn_tpu_torch.data.loaders import LinkDataset
    from ocn_tpu_torch.sparse import build as B

    n = data["n"]
    split = {"train": {"edge": data["train"]},
             "valid": {"edge": data["valid"], "edge_neg": data["valid_neg"]},
             "test": {"edge": data["test"], "edge_neg": data["test_neg"]}}
    ei = B.symmetrize_edge_index(data["train"].T, n)
    ds = LinkDataset(name=name, x=data["x"], max_x=-1, edge_index=ei,
                     split_edge=split, n_nodes=n)
    if use_valedges:
        ds.full_edge_index = B.symmetrize_edge_index(
            np.concatenate([ei, data["valid"].T], axis=1), n)
    return ds.reorder_bfs()


def counters() -> Dict[str, int]:
    """Launches of the port's kernels so far, by its wrappers' counters
    (advanced by every replay of a captured step)."""
    from ocn_tpu_torch.ops.membership import membership_counts
    from ocn_tpu_torch.ops.segment_sum import segment_sum_raw

    return {"membership": membership_counts.launches,
            "segment_sum": segment_sum_raw.launches}


def named_parameters(state) -> Dict:
    """The TrainState's parameters by name, encoder.* then predictor.*."""
    out = {f"encoder.{k}": v for k, v in state.encoder.named_parameters()}
    out.update({f"predictor.{k}": v for k, v in state.predictor.named_parameters()})
    return out

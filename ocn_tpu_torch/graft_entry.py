"""Compile and dry-run entry points (port of the root ``__graft_entry__.py``).

``entry()`` gives a forward step of the flagship model (cn5 over a puregcn
encoder) and its example arguments: ``fn(*args)`` scores a batch of train
edges.  ``dryrun_multichip(n)`` runs one training epoch on n ranks
(parallel/launch.py): the dp x tp mesh step (tp 2 when n is even), then the
node-sharded path with its full production set (ELL tables, the dual-K
split with the round-robin chunk interleave, maskinput) over all n ranks,
followed by the sharded evaluate.  Both run on the card unless given
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np


def _make(overrides: dict, device: str):
    from ocn_tpu_torch.config import Config
    from ocn_tpu_torch.data.loaders import synthetic_dataset
    from ocn_tpu_torch.train.loop import Trainer

    base = dict(dataset="Cora", predictor="cn5", model="puregcn", mplayers=1,
                hiddim=64, batch_size=256, testbs=256, maskinput=True,
                pad_deg=16, pad_deg2=16, count2_chunk=0)
    cfg = Config(**{**base, **overrides})
    ds = synthetic_dataset("Cora", seed=0, scale=0.2)
    return cfg, ds, Trainer(cfg, ds, device=device)


def entry(device: str = "cuda"):
    """(fn, example_args): fn(state, edges, valid) -> (256,) eval scores."""
    import torch

    _, ds, tr = _make({}, device)
    state = tr.init_state(0)
    edges = torch.as_tensor(np.asarray(ds.split_edge["train"]["edge"][:256]).T,
                            dtype=torch.int64, device=tr.device)
    valid = torch.ones(edges.shape[1], device=tr.device)

    @torch.no_grad()
    def fn(state, edges, valid):
        h = tr.encode(state)
        state.predictor.eval()
        return tr._score_chunk(state, h, tr.g, edges, valid, None, False, tr.adj2)

    return fn, (state, edges, valid)


def _dryrun_rank(info, n: int) -> dict:
    """One rank of dryrun_multichip."""
    tp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // tp
    _, _, tr = _make({"dp_devices": dp, "tp_devices": tp, "batch_size": 64 * dp,
                      "linkbatchsize": 32 * dp}, str(info.device))
    state = tr.init_state(0)
    state, loss = tr.train_epoch(state, np.random.default_rng(0), epoch=1)
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite mesh loss {loss}")
    _, _, tr2 = _make({"batch_size": 64 * n, "linkbatchsize": 32, "dp_devices": n,
                       "graph_sharding": "node", "ell_tables": True, "k_small": 8,
                       "small_frac": 0.5, "small_frac_neg": 0.5, "testbs": 256},
                      str(info.device))
    if not (tr2._use_ell and tr2._split is not None):
        raise AssertionError("the dry run must drive the production sharded "
                             "config (ELL tables and the dual-K split)")
    state2 = tr2.init_state(0)
    state2, loss2 = tr2.train_epoch(state2, np.random.default_rng(0), 1)
    res2 = tr2.evaluate(state2)
    if not (np.isfinite(loss2)
            and all(np.isfinite(v) for vals in res2.values() for v in vals)):
        raise FloatingPointError(f"non-finite sharded loss {loss2} or Hits {res2}")
    return {"dp": dp, "tp": tp, "loss": loss, "sharded_loss": loss2,
            "hits": res2, "backend": info.backend}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """One epoch of the mesh step and of the node-sharded path on
    ``n_devices`` ranks; prints rank 0's summary, returns every rank's."""
    from ocn_tpu_torch.parallel.launch import launch

    out = launch(_dryrun_rank, n_devices, n_devices, device=device)
    r = out[0]
    print(f"dryrun_multichip ok: {r['backend']} ranks, mesh dp={r['dp']} "
          f"tp={r['tp']}, loss={r['loss']:.4f}; node-sharded graph "
          f"dp={n_devices} (ELL + dual-K + sharded eval), "
          f"loss={r['sharded_loss']:.4f}, Hits@20={r['hits']['Hits@20']}")
    return out

"""Degree-capped resampling of CN frames (port of ocn_tpu/ops/sample.py;
the reference's sparsesample_reweight semantics).

Rows of a frame with more than ``r`` valid lanes are resampled down to ``r``
lanes carrying importance weight (valid lanes)/r; smaller rows keep their
valid lanes with weight 1.  The output is a (B, r) frame whose lanes are
re-sorted by id.  Used for the cndeg cap on the CN sets and the
trndeg/tstdeg caps on the incomplete family's residual sets.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ocn_tpu_torch.ops.frame import CNFrame
from ocn_tpu_torch.parallel import shard


def sample_frame(cn: CNFrame, r: int, gen: Optional[torch.Generator]) -> CNFrame:
    """Resample each row of ``cn`` to at most ``r`` lanes.

    With ``gen`` None capped rows take evenly strided valid lanes (the
    deterministic path, equal to the JAX package's bit for bit); otherwise
    lanes are drawn uniformly with replacement from one (B, r) uniform draw
    of ``gen``."""
    b, k = cn.ids.shape
    if r >= k:
        return cn
    dev = cn.ids.device
    # csum[b, j] = valid lanes at index <= j; t = the row's valid lanes
    csum = torch.cumsum(cn.mask.long(), dim=-1)
    t = csum[:, -1:]
    m_keep = torch.arange(r, device=dev).expand(b, r)
    if gen is None:
        stride = torch.clamp(t, min=1).float() / r
        m_samp = torch.minimum((m_keep.float() * stride).long(), t - 1)
    else:
        u = shard.rand((b, r), gen, dev)
        m_samp = torch.minimum((u * t.float()).long(), t - 1)
    capped = t > r
    m = torch.where(capped, m_samp, m_keep)
    # the lane of the m-th valid lane: the first j with csum[j] == m + 1
    j = torch.clamp(torch.searchsorted(csum, m + 1), max=k - 1)
    ids = torch.gather(cn.ids, 1, j)
    val = torch.gather(cn.val, 1, j)
    w = torch.where(capped, t.float() / r, 1.0)
    val = torch.where(capped | (m_keep < t), val * w, 0.0)
    ids = torch.where(val != 0, ids, cn.n_nodes).to(cn.ids.dtype)
    # re-sort lanes by id so the sorted-row invariants hold downstream
    order = torch.argsort(ids, dim=-1, stable=True)
    return CNFrame(ids=torch.gather(ids, 1, order),
                   val=torch.gather(val, 1, order), n_nodes=cn.n_nodes)


def sample_frames(frames: List[CNFrame], r: int,
                  gen: Optional[torch.Generator]) -> List[CNFrame]:
    """sample_frame of each frame from the same uniform draw, as the JAX
    package samples them with one key: ``gen`` is rewound to its state
    before the first draw for each frame, and is left after one draw."""
    state = gen.get_state() if gen is not None else None
    out = []
    for f in frames:
        if state is not None:
            gen.set_state(state)
        out.append(sample_frame(f, r, gen))
    return out

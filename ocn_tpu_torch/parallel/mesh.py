"""The ("dp", "tp") mesh (port of ocn_tpu/parallel/mesh.py).

* "dp" - edge-batch data parallelism: the ranks of a "dp" group score
  shares of the link batch;
* "tp" - hidden-dimension tensor parallelism for the predictor: the ranks
  of a "tp" group hold column shares of the hidden states.

Rank r of a dp x tp world sits at (r // tp, r % tp), the layout of
``np.asarray(devices).reshape(dp, tp)`` in the JAX package.  A ``Mesh``
is made inside a running process group (parallel/launch.py) by every rank,
in the same order: each rank creates every axis group, as
``torch.distributed.new_group`` requires.  It carries the ``Collectives``
of the group (calls and bytes counted by op).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ocn_tpu_torch.parallel.launch import Collectives


@dataclasses.dataclass
class Mesh:
    dp: int
    tp: int
    rank: int
    device: torch.device
    comm: Collectives
    dp_group: Optional[object]   # this rank's "dp" group (None when dp == 1)
    tp_group: Optional[object]   # this rank's "tp" group (None when tp == 1)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def size(self) -> int:
        return self.dp * self.tp


def make_mesh(dp: int = 1, tp: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """The dp x tp mesh over the running process group, whose size must be
    dp * tp; ``device`` is this rank's (default: the current CUDA device
    under nccl, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a dp={dp} x tp={tp} mesh needs a running process group: run "
            "the ranks with ocn_tpu_torch.parallel.launch.launch")
    world = dist.get_world_size()
    if world != dp * tp:
        raise ValueError(f"need {dp * tp} ranks for dp={dp} x tp={tp}, "
                         f"have {world}")
    rank = dist.get_rank()
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    dp_group = tp_group = None
    # every rank creates every group, in one order
    for t in range(tp):
        ranks = [d * tp + t for d in range(dp)]
        g = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            dp_group = g
    for d in range(dp):
        ranks = [d * tp + t for t in range(tp)]
        g = dist.new_group(ranks) if tp > 1 else None
        if rank in ranks:
            tp_group = g
    return Mesh(dp=dp, tp=tp, rank=rank, device=torch.device(device),
                comm=Collectives(backend, torch.device(device)),
                dp_group=dp_group, tp_group=tp_group)

"""Ranks and collectives: the process side of the port's multi-device tier.

JAX runs every device of a mesh in one process (``jax.shard_map``, GSPMD);
PyTorch's model is one process per rank.  ``launch(fn, nranks, ...)``
spawns ``nranks`` processes ("spawn" start method), joins them into one
``torch.distributed`` group through a ``file://`` store in a temporary
directory (no TCP port, so concurrent launches cannot clash), places rank r
on ``cuda:{r % device_count}`` or on the CPU, calls ``fn(RankInfo, *args)``
in each, and returns every rank's result (written with ``torch.save`` and
read back here).  A rank that raises fails the launch: its peers are
terminated and the error is raised in the caller; ``init_process_group``
gets ``timeout_s``, so a peer that died cannot hang the others in a
collective for longer.

The backend is fixed before launch by ``backend_for``: "nccl" when every
rank has a card of its own, "gloo" when ranks share a card or run on the
CPU.  Nothing switches after a failure.

``Collectives`` wraps the operations the tier uses (all-reduce, all-gather,
all-to-all, reduce-scatter, the ring shift) and counts calls and bytes by
op, the way ``membership_counts.launches`` counts kernel launches.  Under
gloo, CUDA tensors are staged through host memory, and reduce-scatter is an
all-reduce of which each rank keeps its slice: the route follows the
backend, chosen up front, and never a caught error.  The autograd Functions
at the end give each collective its transpose for the backward.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """What a rank body is told: its rank, its device and the group's
    backend."""

    rank: int
    device: torch.device
    backend: str


def backend_for(nranks: int, device_type: str) -> str:
    """"nccl" when every rank has a CUDA card of its own, else "gloo"
    (ranks that share a card, or CPU ranks)."""
    if device_type == "cuda" and nranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _rank_main(rank: int, fn: Callable, args: tuple, nranks: int,
               device_type: str, backend: str, tmp: str, timeout_s: float,
               threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=nranks,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(RankInfo(rank, device, backend), *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nranks: int, *args, device: str = "cuda",
           timeout_s: float = 600.0, threads: Optional[int] = None,
           deadline_s: float = 3600.0) -> List[Any]:
    """Run ``fn(RankInfo, *args)`` in ``nranks`` spawned ranks; returns the
    list of their results in rank order.  ``fn`` and ``args`` are pickled
    (``fn`` by import path), results pass through ``torch.save``.
    ``device="cuda"`` raises without a card; ``threads`` sets each rank's
    intra-op thread count, by default the caller's divided among the ranks
    (they share the host's cores).  ``timeout_s`` bounds a collective's
    wait, ``deadline_s`` the whole launch: past it every rank is killed and
    TimeoutError raised."""
    import time

    import torch.multiprocessing as mp

    if threads is None:
        threads = max(1, torch.get_num_threads() // nranks)

    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch(device='cuda') needs a CUDA device; pass "
                           "device='cpu' to run the ranks on the CPU")
    backend = backend_for(nranks, device_type)
    with tempfile.TemporaryDirectory(prefix="ocn_ranks_") as tmp:
        ctx = mp.spawn(_rank_main, nprocs=nranks, join=False,
                       args=(fn, args, nranks, device_type, backend, tmp,
                             timeout_s, threads))
        end = time.monotonic() + deadline_s
        try:
            # join raises as soon as a rank fails (and terminates the rest)
            while not ctx.join(timeout=1.0):
                if time.monotonic() > end:
                    raise TimeoutError(f"{nranks} ranks of {fn.__name__} still "
                                       f"running after {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nranks)]


class Collectives:
    """The tier's collectives over process groups of one backend, with
    calls and bytes (this rank's contribution) counted by op."""

    def __init__(self, backend: str, device: torch.device):
        self.backend = backend
        # gloo takes CUDA tensors only through host memory here
        self.staged = backend == "gloo" and device.type == "cuda"
        self.calls = collections.Counter()
        self.bytes = collections.Counter()

    def _count(self, op: str, t: torch.Tensor) -> None:
        self.calls[op] += 1
        self.bytes[op] += t.numel() * t.element_size()

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().cpu() if self.staged else t.detach()

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device) if self.staged else t

    def all_reduce(self, t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
        """A new tensor: the sum (or max) of ``t`` over the group."""
        self._count("all_reduce", t)
        buf = self._host(t).clone()
        dist.all_reduce(buf, {"sum": dist.ReduceOp.SUM,
                              "max": dist.ReduceOp.MAX}[op], group=group)
        return self._back(buf, t)

    def all_gather(self, t: torch.Tensor, group) -> torch.Tensor:
        """(group size, *t.shape): every rank's ``t`` in group-rank order."""
        self._count("all_gather", t)
        src = self._host(t).contiguous()
        out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, src, group=group)
        return self._back(torch.stack(out), t)

    def all_to_all(self, t: torch.Tensor, group) -> torch.Tensor:
        """``t`` of (size * m, ...) in size equal blocks: block s goes to
        group rank s; returns the blocks received, in sender order."""
        self._count("all_to_all", t)
        src = self._host(t).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return self._back(out, t)

    def reduce_scatter(self, t: torch.Tensor, group) -> torch.Tensor:
        """``t`` of (size * m, ...): block r of the sum over the group, on
        group rank r.  gloo: an all-reduce of which each rank keeps its
        block."""
        self._count("reduce_scatter", t)
        size = dist.get_world_size(group)
        me = dist.get_rank(group)
        m = t.shape[0] // size
        if self.backend == "gloo":
            buf = self._host(t).clone()
            dist.all_reduce(buf, group=group)
            return self._back(buf[me * m:(me + 1) * m].clone(), t)
        out = torch.empty((m,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
        return out

    def ring_shift(self, t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
        """Send ``t`` to group rank (r + step) % size, return what group rank
        (r - step) % size sent (send and receive batched)."""
        self._count("ring", t)
        size = dist.get_world_size(group)
        me = dist.get_rank(group)
        src = self._host(t).contiguous()
        out = torch.empty_like(src)
        peer_to = dist.get_global_rank(group, (me + step) % size)
        peer_from = dist.get_global_rank(group, (me - step) % size)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, peer_to, group),
            dist.P2POp(dist.irecv, out, peer_from, group)])
        for req in reqs:
            req.wait()
        return self._back(out, t)

    def sum_grads(self, params, group, size: int) -> None:
        """Sum the gradients of ``params`` over ``group`` (of ``size``
        ranks; None: every rank) in one flat all-reduce.  Parameters without
        a gradient take no part: the ranks run one program, so they agree on
        which."""
        params = [p for p in params if p.grad is not None]
        if size == 1 or not params:
            return
        flat = self.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]),
                               group)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p.grad))

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def record(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


class AllGatherRows(torch.autograd.Function):
    """Concatenate each group rank's rows, in group-rank order.  Backward
    ``"sum"``: the consumers differ by rank, so each rank's rows get the sum
    of every rank's cotangent (reduce-scatter, the transpose of the
    all-gather); ``"slice"``: every rank computes the same function of the
    gathered rows (a loss), so a rank's rows get its own cotangent's
    slice."""

    @staticmethod
    def forward(ctx, t, comm, group, backward):
        ctx.comm, ctx.group, ctx.backward, ctx.m = comm, group, backward, t.shape[0]
        out = comm.all_gather(t, group)
        return out.reshape((-1,) + tuple(t.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "sum":
            return ctx.comm.reduce_scatter(g.contiguous(), ctx.group), None, None, None
        me = dist.get_rank(ctx.group)
        return g[me * ctx.m:(me + 1) * ctx.m], None, None, None


class AllToAll(torch.autograd.Function):
    """all-to-all of equal blocks; its own transpose."""

    @staticmethod
    def forward(ctx, t, comm, group):
        ctx.comm, ctx.group = comm, group
        return comm.all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_to_all(g.contiguous(), ctx.group), None, None


class AllReduceSum(torch.autograd.Function):
    """Sum over the group.  Backward ``"sum"``: the sum feeds rank-specific
    work, so each rank's input gets the sum of the cotangents;
    ``"identity"``: every rank consumes the sum identically (the partial
    products of a row-parallel layer), so each partial gets the cotangent
    as it is."""

    @staticmethod
    def forward(ctx, t, comm, group, backward):
        ctx.comm, ctx.group, ctx.backward = comm, group, backward
        return comm.all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "identity":
            return g, None, None, None
        return ctx.comm.all_reduce(g, ctx.group), None, None, None


class RingShift(torch.autograd.Function):
    """ring_shift by ``step``; the backward shifts the cotangent back."""

    @staticmethod
    def forward(ctx, t, comm, group, step):
        ctx.comm, ctx.group, ctx.step = comm, group, step
        return comm.ring_shift(t, group, step)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.ring_shift(g, ctx.group, -ctx.step), None, None, None

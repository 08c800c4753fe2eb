"""Node-sharded training and eval (port of ocn_tpu/parallel/sharded_graph.py).

With ``Config.graph_sharding="node"`` on ``dp_devices`` ranks, each rank's
device holds only row-range shards of the graph, the ``rows_per`` nodes
[r0, r0 + rows_per):

* the features and the adjacency, the latter in the boundary partition of
  parallel/node_sharded.py: the encoder runs unchanged on a ``LocalGraph``
  (ops/spmm.py and nn/conv.py dispatch to its methods), whose SpMM ships
  each peer exactly the rows it needs in one all-to-all (the halo);
* the window tables of g, A^2 and cn6's A^3 (``LocalWindows``), as CSR
  windows or as the current refresh's ELL tables: CN-frame gathers run as
  "owner-gather + reduce-scatter" (``sharded_gather_neighbors``): every
  rank all-gathers the requests, answers the ones whose rows it owns, and a
  reduce-scatter returns each requester its windows (one owner per row, so
  the sum is the owner's answer);
* maskinput zeroes values in the local shards at positions routed on the
  host (``route_mask_positions``, ``route_ell_mask``).

After the encoder, h (the smallest per-node array) is all-gathered once a
step; each rank scores its own chunks of the batch (with the dual-K split:
nsp/ndev small and nbp/ndev big chunks, Trainer._chunk_interleave), the
scores are all-gathered and every rank computes the loss of the whole batch
in its original order.  The gradients are summed over the ranks; the EMA
buffers, stepped by each rank's own chunk sequence, are averaged.  With
sampling off this equals the explicit DP step (parallel/spmd.py) with the
same per-rank chunks.  Each rank draws its dropout from a generator of its
own, seeded from the shared one and its rank.

Scope, as in the JAX package: the frame-based predictors (cn1, cn5-cn9;
cn6's A^3 rides as a third set of shards), two_hop_mode="gather", no
window table, no hoisted frames, tp 1 (Config.require_supported).
``ShardedEval`` keeps the graph sharded through eval: the encoder on the
shards, then one all-gather of h, and the scorers against the sharded
tables.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ocn_tpu_torch.ops.frame import NeighborFrame
from ocn_tpu_torch.parallel.launch import AllGatherRows, AllToAll
from ocn_tpu_torch.parallel.node_sharded import (
    segment_sum, partition_graph_boundary)
from ocn_tpu_torch.sparse import ell as ELL
from ocn_tpu_torch.sparse.csr import GATHER_PAD, Graph


# --------------------------------------------------------------------------
# the encoder's view of one rank's adjacency shard
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalGraph:
    """One rank's adjacency shard in the layout of
    node_sharded.partition_graph_boundary: "interior" entries whose source
    lies on this rank (``icol`` local source ids) and "boundary" entries
    whose source is remote (``bpos`` positions in the halo inbox).  Each
    value array carries one trailing pad slot, where routed mask padding
    lands.  Index tensors are int64, on the rank's device."""

    mesh: object
    sidx: torch.Tensor   # (ndev * bmax,) local rows each peer needs, by peer
    icol: torch.Tensor
    irow: torch.Tensor   # nondecreasing local destination rows
    ival: torch.Tensor
    bpos: torch.Tensor
    brow: torch.Tensor
    bval: torch.Tensor
    rows_per: int
    n_nodes: int

    def _halo(self, x_local: torch.Tensor) -> torch.Tensor:
        """The (ndev * bmax, H) inbox: from each peer, the rows we need."""
        return AllToAll.apply(x_local[self.sidx], self.mesh.comm,
                              self.mesh.dp_group)

    def value_rowsum(self) -> torch.Tensor:
        return (segment_sum(self.ival, self.irow, self.rows_per)
                + segment_sum(self.bval, self.brow, self.rows_per))

    def drop_edges(self, p: float, gen: Optional[torch.Generator] = None,
                   doscale: bool = True) -> "LocalGraph":
        """Value-space DropAdj on the local shard, from this rank's
        generator (entrywise Bernoulli, as on one device)."""
        if p < 1e-6:
            return self
        scale = 1.0 / (1.0 - p) if doscale else 1.0
        keep_i = torch.rand(self.ival.shape, generator=gen,
                            device=self.ival.device) < 1.0 - p
        keep_b = torch.rand(self.bval.shape, generator=gen,
                            device=self.bval.device) < 1.0 - p
        return dataclasses.replace(
            self, ival=torch.where(keep_i, self.ival * scale, 0.0),
            bval=torch.where(keep_b, self.bval * scale, 0.0))

    def sharded_spmm(self, x_local: torch.Tensor, aggr: str = "sum") -> torch.Tensor:
        halo = self._halo(x_local)
        mi = self.ival[:, None].to(x_local.dtype) * x_local[self.icol]
        mb = self.bval[:, None].to(x_local.dtype) * halo[self.bpos]
        if aggr in ("sum", "mean"):
            s = (segment_sum(mi, self.irow, self.rows_per)
                 + segment_sum(mb, self.brow, self.rows_per))
            if aggr == "sum":
                return s
            cnt = (segment_sum((self.ival != 0).to(x_local.dtype), self.irow,
                                self.rows_per)
                   + segment_sum((self.bval != 0).to(x_local.dtype), self.brow,
                                  self.rows_per))
            return s / cnt.clamp_min(1.0)[:, None]
        if aggr == "max":
            neg = torch.finfo(x_local.dtype).min
            m = torch.full((self.rows_per, x_local.shape[-1]), neg,
                           dtype=x_local.dtype, device=x_local.device)
            for msg, val, rows in ((mi, self.ival, self.irow),
                                   (mb, self.bval, self.brow)):
                masked = torch.where((val != 0)[:, None], msg, neg)
                m = m.scatter_reduce(0, rows[:, None].expand_as(masked), masked,
                                     reduce="amax")
            return torch.where(m <= neg, 0.0, m)
        raise ValueError(f"unknown aggr {aggr!r}")

    def gcn_norm_conv(self, x_local: torch.Tensor) -> torch.Tensor:
        # norm*(A @ (norm*x) + norm*x): remote norms ride inside xn's halo
        norm = torch.rsqrt(1.0 + self.value_rowsum()).to(x_local.dtype)[:, None]
        xn = norm * x_local
        return norm * (self.sharded_spmm(xn, "sum") + xn)

    def gcn_selfloop_conv(self, x_local: torch.Tensor) -> torch.Tensor:
        norm = torch.rsqrt(self.value_rowsum() + 1.0).to(x_local.dtype)[:, None]
        xn = norm * x_local
        return norm * (self.sharded_spmm(xn, "sum") + xn)

    def gcn_enorm_conv(self, x_local: torch.Tensor) -> torch.Tensor:
        """PureConvV2 'gcn': edge weights norm[i] * norm[j], no self term;
        the remote sources' norms arrive in one halo of [x | norm]."""
        norm = torch.rsqrt(1.0 + self.value_rowsum()).to(x_local.dtype)
        halo = self._halo(torch.cat([x_local, norm[:, None]], dim=-1))
        halo_x, halo_n = halo[:, :-1], halo[:, -1]
        iw = (self.ival * norm[self.irow] * norm[self.icol])[:, None]
        bw = (self.bval * norm[self.brow] * halo_n[self.bpos])[:, None]
        return (segment_sum(iw.to(x_local.dtype) * x_local[self.icol], self.irow,
                             self.rows_per)
                + segment_sum(bw.to(x_local.dtype) * halo_x[self.bpos], self.brow,
                               self.rows_per))


# --------------------------------------------------------------------------
# one rank's window tables for the CN-frame gathers
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalWindows:
    """One rank's window-table shard, rows [r0, r0 + rows_per): local CSR
    ``ip`` into the local ``col``/``val`` (global column ids), or, with
    ``ell``, its (rows_per, ell_k) rows of the current ELL table, which then
    answer instead (pass 1-wide ip/col/val).  ``gather_neighbors`` sees
    ``sharded_gather`` and answers through sharded_gather_neighbors."""

    mesh: object
    ip: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    deg: torch.Tensor
    r0: int
    rows_per: int
    n_nodes: int
    ell: Optional[torch.Tensor] = None
    ell_k: int = 0
    col_bits: int = 0

    def sharded_gather(self, nodes, k, gen=None) -> NeighborFrame:
        return sharded_gather_neighbors(self, nodes, k, gen)


def sharded_gather_neighbors(lw: LocalWindows, nodes: torch.Tensor, k: int,
                             gen: Optional[torch.Generator] = None
                             ) -> NeighborFrame:
    """gather_neighbors (window sampling) against a row-sharded table.

    Owner-gather + reduce-scatter: all-gather the (C,) requests of every
    rank, answer those whose rows this rank owns (window slices of the local
    arrays, the math of ops/frame.py gather_neighbors), zeros elsewhere, and
    reduce-scatter the (ndev*C, k) answers so each requester gets exactly
    its windows; invalid lanes carry the sentinel n_nodes.  A capped row's
    window offset comes from its requester's draw, all-gathered with the
    requests, so it equals the requester gathering alone.  With an ELL
    shard (k <= ell_k) the owner answers from the frozen table and nothing
    is drawn.  The frame carries no CSR positions (no window table here)."""
    comm, group = lw.mesh.comm, lw.mesh.dp_group
    nodes = nodes.long()
    c = nodes.shape[0]
    flat = comm.all_gather(nodes, group).reshape(-1)
    loc = flat - lw.r0
    own = (loc >= 0) & (loc < lw.rows_per) & (flat < lw.n_nodes)
    locc = torch.clamp(loc, 0, lw.rows_per - 1)
    deg = torch.where(own, lw.deg[locc], 0)
    lane = torch.arange(k, device=flat.device)[None, :]
    capped = deg > k
    w_row = torch.where(capped, deg.float() / k, 1.0)
    valid = lane < torch.clamp(deg, max=k)[:, None]
    if lw.ell is not None and k <= lw.ell_k:
        pk = lw.ell[locc][:, :k]
        ids_w = pk & ((1 << lw.col_bits) - 1)
        vals_w = (pk >> lw.col_bits).float()
    else:
        start = lw.ip[locc].long()
        if gen is not None:
            u = torch.rand(c, generator=gen, device=nodes.device)
            u = comm.all_gather(u, group).reshape(-1)
            woff = torch.where(capped, (u * (deg - k + 1).float()).long(), 0)
        else:
            woff = torch.zeros_like(start)
        pos0 = torch.clamp(start + woff, max=max(lw.col.shape[0] - k, 0))
        ids_w = lw.col[pos0[:, None] + lane]
        vals_w = lw.val[pos0[:, None] + lane]
    w = torch.where(own[:, None] & valid, w_row[:, None] * vals_w, 0.0)
    # the owner puts the sentinel on its invalid lanes; non-owners put 0
    ids = torch.where(own[:, None], torch.where(valid, ids_w.long(), lw.n_nodes), 0)
    ids = comm.reduce_scatter(ids.int().contiguous(), group)
    w = comm.reduce_scatter(w.contiguous(), group)
    return NeighborFrame(ids=ids, w=w, n_nodes=lw.n_nodes, pos=None)


# --------------------------------------------------------------------------
# host-side partitioning (NumPy, as in the JAX package)
# --------------------------------------------------------------------------

def _csr_host(g: Graph):
    ip = g.indptr.cpu().numpy().astype(np.int64)
    nnz = int(ip[-1])
    if g.col is not None:
        return ip, g.col.cpu().numpy()[:nnz], g.val.cpu().numpy()[:nnz]
    # a gather-only graph (packed col|val only): unpack
    pk = g.packed.cpu().numpy()[:nnz].astype(np.int64)
    return (ip, (pk & ((1 << g.col_bits) - 1)).astype(np.int32),
            (pk >> g.col_bits).astype(np.float32))


def partition_windows(g: Graph, ndev: int):
    """A graph's CSR window table in row-range shards: stacked (wip, wcol,
    wval, wdeg, wpos0), wpos0[d] the global nnz offset of shard d (for mask
    routing); arrays padded to a common length + GATHER_PAD + one pad slot
    for mask-scatter padding."""
    ip, col, val = _csr_host(g)
    n = g.n_nodes
    rows_per = -(-n // ndev)
    ips, cols, vals, degs, offs = [], [], [], [], []
    for d in range(ndev):
        r0, r1 = d * rows_per, min((d + 1) * rows_per, n)
        lo, hi = int(ip[r0]), int(ip[r1])
        lip = ip[r0:r1 + 1] - lo
        if r1 - r0 < rows_per:  # last shard: pad rows with empty windows
            lip = np.concatenate([lip, np.full(rows_per - (r1 - r0), lip[-1],
                                               np.int64)])
        ips.append(lip.astype(np.int32))
        cols.append(col[lo:hi])
        vals.append(val[lo:hi])
        degs.append((lip[1:] - lip[:-1]).astype(np.int32))
        offs.append(lo)
    m = max(len(c) for c in cols) + GATHER_PAD + 1  # +1 = mask pad slot

    def pad(arrs, dtype):
        return np.stack([np.concatenate([a, np.zeros(m - len(a), dtype)]).astype(dtype)
                         for a in arrs])

    return (np.stack(ips), pad(cols, np.int32), pad(vals, np.float32),
            np.stack(degs), np.asarray(offs, np.int64))


def boundary_entry_layout(g: Graph, ndev: int) -> dict:
    """For mask routing: each global nnz position's place in the boundary
    partition's per-rank [interior | boundary] entry arrays (the packing
    order of partition_graph_boundary: CSR order filtered by own/~own)."""
    ip, col, _ = _csr_host(g)
    true_nnz = int(ip[-1])
    n = g.n_nodes
    rows_per = -(-n // ndev)
    dev = np.zeros(true_nnz, np.int32)
    kind = np.zeros(true_nnz, np.int8)   # 0 interior, 1 boundary
    slot = np.zeros(true_nnz, np.int64)
    for d in range(ndev):
        r0, r1 = d * rows_per, min((d + 1) * rows_per, n)
        lo, hi = int(ip[r0]), int(ip[r1])
        c = col[lo:hi]
        own = (c >= r0) & (c < r0 + rows_per)
        dev[lo:hi] = d
        kind[lo:hi] = np.where(own, 0, 1)
        s = np.zeros(hi - lo, np.int64)
        s[own] = np.arange(own.sum())
        s[~own] = np.arange((~own).sum())
        slot[lo:hi] = s
    return {"dev": dev, "kind": kind, "slot": slot, "rows_per": rows_per}


def route_mask_positions(layout: dict, wpos0: np.ndarray, positions: np.ndarray,
                         ndev: int, cap: int, pad_i: int, pad_b: int, pad_w: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global nnz mask positions -> per-rank scatter indices (mi, mb, mw),
    each (ndev, cap), into the padded ival / bval / wval arrays; unused
    lanes point at the trailing pad slot."""
    positions = np.asarray(positions, np.int64)
    dev = layout["dev"][positions]
    kind = layout["kind"][positions]
    slot = layout["slot"][positions]
    wslot = positions - wpos0[dev]
    mi = np.full((ndev, cap), pad_i, np.int32)
    mb = np.full((ndev, cap), pad_b, np.int32)
    mw = np.full((ndev, cap), pad_w, np.int32)
    for d in range(ndev):
        sel = dev == d
        ps, ks, ws = slot[sel], kind[sel], wslot[sel]
        if len(ps) > cap:
            raise ValueError(f"mask routing overflow: device {d} owns {len(ps)} "
                             f"masked positions > cap {cap}; raise the cap")
        ii, bb = ps[ks == 0], ps[ks == 1]
        mi[d, :len(ii)] = ii
        mb[d, :len(bb)] = bb
        mw[d, :len(ws)] = ws
    return mi, mb, mw


def partition_ell(tbl: np.ndarray, ndev: int, rows_per: int) -> np.ndarray:
    """An (N, K) ELL table as (ndev, rows_per, K) row-range shards
    (zero-padded tail rows are masked by ``own`` in the gather)."""
    n, k = tbl.shape
    pad = ndev * rows_per - n
    if pad:
        tbl = np.concatenate([tbl, np.zeros((pad, k), tbl.dtype)], axis=0)
    return tbl.reshape(ndev, rows_per, k)


def route_ell_mask(flat: np.ndarray, cleared: np.ndarray, ndev: int,
                   rows_per: int, k: int, cap: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Global ELL flat mask positions (sparse/ell.py mask_ell_flat_positions;
    -1 = an edge outside its row's frozen window) -> per-rank LOCAL flat
    positions and the cleared entries, (ndev, cap) each; unused lanes hold
    the positive out-of-range sentinel rows_per * k, which the scatter
    drops."""
    flat = np.asarray(flat, np.int64)
    ok = flat >= 0
    rows = flat // k
    dev = np.where(ok, rows // rows_per, 0)
    lflat = flat - dev * (np.int64(rows_per) * k)
    me = np.full((ndev, cap), rows_per * k, np.int32)
    mc = np.zeros((ndev, cap), np.int32)
    for d in range(ndev):
        sel = ok & (dev == d)
        ps, cs = lflat[sel], np.asarray(cleared)[sel]
        if len(ps) > cap:
            raise ValueError(f"ELL mask routing overflow: device {d} owns "
                             f"{len(ps)} masked positions > cap {cap}; raise the cap")
        me[d, :len(ps)] = ps
        mc[d, :len(ps)] = cs
    return me, mc


def _pad_rows(a: np.ndarray, ndev: int, rows_per: int) -> np.ndarray:
    pad = ndev * rows_per - a.shape[0]
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]).reshape(
        (ndev, rows_per) + a.shape[1:])


def refresh_sharded_ell(tr, rng: np.random.Generator) -> dict:
    """The ELL tables of one refresh, node-sharded: offsets drawn as on one
    device (g at the sharded width, A^2 at pad_deg2, cn6's A^3 at k3, in
    that order), the (N, K) tables built on the host, and only this rank's
    (rows_per, K) rows put on its device."""
    cfg, mesh = tr.cfg, tr.mesh
    ndev, me = mesh.dp, mesh.dp_rank
    rows_per = -(-tr.g.n_nodes // ndev)

    def shard_of(g: Graph, off: np.ndarray, k: int) -> torch.Tensor:
        tbl = ELL.build_ell_np(g.packed.numpy(), g.indptr.numpy(), off, k)
        return torch.as_tensor(partition_ell(tbl, ndev, rows_per)[me],
                               device=tr.device)

    k1 = tr._sharded_ell_k1()
    off1 = ELL.draw_offsets(tr._deg_np, k1, rng)
    off2 = ELL.draw_offsets(tr.adj2.deg.numpy(), cfg.pad_deg2, rng)
    out = {"tbl1_sh": shard_of(tr.g, off1, k1),
           "tbl2_sh": shard_of(tr.adj2, off2, cfg.pad_deg2), "off1_np": off1}
    if tr.adj3 is not None:
        k3 = tr._k3_width()
        off3 = ELL.draw_offsets(tr.adj3.deg.numpy(), k3, rng)
        out["tbl3_sh"] = shard_of(tr.adj3, off3, k3)
    return out


# --------------------------------------------------------------------------
# one rank's shards
# --------------------------------------------------------------------------

class _Shards:
    """This rank's device shards of a graph (and its A^2, A^3): the encoder's
    LocalGraph arrays, the features, and the window tables (CSR windows, or
    degrees only when the ELL tables answer)."""

    def __init__(self, tr, g: Graph, adj2: Graph, adj3: Optional[Graph],
                 use_ell: bool, mesh=None):
        mesh = mesh if mesh is not None else tr.mesh
        ndev, me, dev = mesh.dp, mesh.dp_rank, tr.device
        self.mesh, self.n_nodes, self.use_ell = mesh, g.n_nodes, use_ell
        bp = partition_graph_boundary(g, ndev)
        self.bp = bp
        self.rows_per = rows_per = bp.rows_per

        def put(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        def with_pad(a, fill):
            return np.concatenate([a, np.full(1, fill, a.dtype)])

        lg = dict(
            sidx=put(bp.send_idx[me].reshape(-1), torch.int64),
            icol=put(with_pad(bp.icol[me], 0), torch.int64),
            irow=put(with_pad(bp.irow[me], rows_per - 1), torch.int64),
            ival=put(with_pad(bp.ival[me], 0.0)),
            bpos=put(with_pad(bp.bpos[me], 0), torch.int64),
            brow=put(with_pad(bp.brow[me], rows_per - 1), torch.int64),
            bval=put(with_pad(bp.bval[me], 0.0)))
        self.pad_i, self.pad_b = bp.icol.shape[1], bp.bpos.shape[1]
        self.graph = LocalGraph(mesh=mesh, rows_per=rows_per, n_nodes=g.n_nodes, **lg)
        x = tr.x.cpu()
        x = (x if x.dtype != torch.bfloat16 else x.float()).numpy()
        self.x = put(_pad_rows(x, ndev, rows_per)[me], tr.x.dtype)
        self.r0 = me * rows_per
        self.layout = boundary_entry_layout(g, ndev)
        self.tables = []
        for i, gg in enumerate((g, adj2, adj3)):
            if gg is None:
                self.tables.append(None)
                continue
            if use_ell:
                deg = _pad_rows(gg.deg.cpu().numpy().astype(np.int32), ndev,
                                rows_per)[me]
                one = torch.zeros(1, dtype=torch.int64, device=dev)
                arrs = (one, one, torch.zeros(1, device=dev), put(deg, torch.int64))
                if i == 0:
                    self.wpos0, self.pad_w = np.zeros(ndev, np.int64), 0
            else:
                wip, wcol, wval, wdeg, wpos0 = partition_windows(gg, ndev)
                arrs = (put(wip[me], torch.int64), put(wcol[me], torch.int64),
                        put(wval[me]), put(wdeg[me], torch.int64))
                if i == 0:
                    self.wpos0, self.pad_w = wpos0, wcol.shape[1] - 1
            self.tables.append((arrs, gg.col_bits))

    def windows(self, i: int, ell: Optional[torch.Tensor] = None,
                val: Optional[torch.Tensor] = None) -> Optional[LocalWindows]:
        """LocalWindows of table i (0 g, 1 A^2, 2 A^3), with its current ELL
        shard, and g's CSR values replaced by the masked ``val``."""
        if self.tables[i] is None:
            return None
        (ip, col, v, deg), bits = self.tables[i]
        return LocalWindows(
            mesh=self.mesh, ip=ip, col=col, val=v if val is None else val,
            deg=deg, r0=self.r0, rows_per=self.rows_per, n_nodes=self.n_nodes,
            ell=ell, ell_k=0 if ell is None else int(ell.shape[1]), col_bits=bits)

    def device_bytes(self, ell: Optional[dict] = None) -> int:
        """Bytes of this rank's shards on the device (with the ELL shards)."""
        ts = [getattr(self.graph, f.name) for f in dataclasses.fields(self.graph)
              if isinstance(getattr(self.graph, f.name), torch.Tensor)]
        ts.append(self.x)
        for tab in self.tables:
            if tab is not None:
                ts.extend(tab[0])
        if ell:
            ts.extend(t for key, t in ell.items() if key.endswith("_sh"))
        return sum(t.numel() * t.element_size() for t in ts)


def rank_generator(gen: Optional[torch.Generator], rank: int, device):
    """This rank's generator for a step: seeded from one draw of the shared
    generator (which every rank draws alike) and the rank."""
    if gen is None:
        return None
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
    return torch.Generator(device=device).manual_seed(seed + rank)


class ShardedGraphStep:
    """The node-sharded train step of one rank (port of
    make_sharded_graph_train_step): ``step(state, pos, neg, aux, gen,
    inv_p, inv_n)`` takes Trainer.prepare_batch's outputs.  ``mesh``
    defaults to the Trainer's own; a single-device Trainer and a mesh given
    here run the bare step over that mesh, with the host's mask positions
    as ``aux``, as the JAX factory takes a Trainer and a mesh."""

    def __init__(self, tr, mesh=None):
        cfg = tr.cfg
        mesh = mesh if mesh is not None else tr.mesh
        self.tr, self.mesh = tr, mesh
        ndev = mesh.dp
        c = tr._chunk()
        if cfg.batch_size % (ndev * c):
            raise ValueError(f"batch_size {cfg.batch_size} must divide into "
                             f"{ndev} ranks x chunk {c}")
        if tr._split is not None and any(n % ndev for n in tr._split):
            raise ValueError("the sharded dual-K split needs per-side chunk "
                             "counts divisible by dp (Trainer._split_plan)")
        self.sh = _Shards(tr, tr.g, tr.adj2, tr.adj3, bool(tr._use_ell), mesh)
        self.mask_cap = 2 * cfg.batch_size

    def route(self, aux):
        """This rank's mask scatters from prepare_batch's host aux: (mi, mb)
        into the LocalGraph values, mw into g's CSR window values (without
        ELL), (me, mc) into g's ELL shard (with); None where nothing
        applies."""
        sh, ndev, me = self.sh, self.mesh.dp, self.mesh.dp_rank
        csr = aux.get("csr") if isinstance(aux, dict) else aux
        if csr is None:
            return None
        mi, mb, mw = route_mask_positions(sh.layout, sh.wpos0, csr, ndev,
                                          self.mask_cap, sh.pad_i, sh.pad_b,
                                          sh.pad_w)
        dev = self.tr.device
        out = {"mi": torch.as_tensor(mi[me], dtype=torch.int64, device=dev),
               "mb": torch.as_tensor(mb[me], dtype=torch.int64, device=dev),
               "mw": torch.as_tensor(mw[me], dtype=torch.int64, device=dev)}
        if isinstance(aux, dict) and aux.get("ell_flat") is not None:
            k1 = self.tr._sharded_ell_k1()
            le, lc = route_ell_mask(aux["ell_flat"], aux["ell_cleared"], ndev,
                                    sh.rows_per, k1, self.mask_cap)
            keep = le[me] < sh.rows_per * k1  # the sentinel lanes drop out
            out["me"] = torch.as_tensor(le[me][keep], dtype=torch.int64, device=dev)
            out["mc"] = torch.as_tensor(lc[me][keep], device=dev)
        return out

    def graphs(self, masks):
        """(LocalGraph, windows of g, A^2, A^3) of one step, masked."""
        sh, tr = self.sh, self.tr
        lg = sh.graph
        if masks is not None:
            lg = dataclasses.replace(
                lg, ival=lg.ival.index_fill(0, masks["mi"], 0.0),
                bval=lg.bval.index_fill(0, masks["mb"], 0.0))
        if sh.use_ell:
            ell = tr._ell
            tbl1 = ell["tbl1_sh"]
            if masks is not None and "me" in masks:
                tbl1 = tbl1.reshape(-1).index_copy(
                    0, masks["me"], masks["mc"].to(tbl1.dtype)).reshape(tbl1.shape)
            return (lg, sh.windows(0, tbl1), sh.windows(1, ell["tbl2_sh"]),
                    sh.windows(2, ell.get("tbl3_sh")))
        val = None
        if masks is not None:
            val = sh.tables[0][0][2].index_fill(0, masks["mw"], 0.0)
        return lg, sh.windows(0, val=val), sh.windows(1), sh.windows(2)

    def loss(self, state, pos, neg, aux, gen, inv_p=None, inv_n=None):
        """The whole batch's loss on every rank, with this rank's autograd
        graph: its encoder shard, its chunks."""
        tr, mesh, cfg = self.tr, self.mesh, self.tr.cfg
        ndev, me = mesh.dp, mesh.dp_rank
        if tr._split is not None and (inv_p is None or inv_n is None):
            raise ValueError("k_small > 0 needs degree-sorted batches; build "
                             "the step inputs with Trainer.prepare_batch")
        lgen = rank_generator(gen, me, tr.device)
        lg, lw1, lw2, lw3 = self.graphs(self.route(aux))
        c = tr._chunk()
        bl = pos.shape[1] // ndev
        pos_l, neg_l = pos[:, me * bl:(me + 1) * bl], neg[:, me * bl:(me + 1) * bl]
        nc = bl // c
        state.encoder.train()
        state.predictor.train()
        h_l = state.encoder(self.sh.x, lg, lgen)
        # h is the smallest per-node array: gathered once a step
        h = AllGatherRows.apply(h_l, mesh.comm, mesh.dp_group, "sum")[:tr.g.n_nodes]

        def body(p, n, n_pos, k=None):
            return tr._score_body(state, h, lw1, torch.cat([p, n], dim=1), n_pos,
                                  lgen, lw2, lw3, k=k, grouped=False)

        if tr._split is None:
            out = body(pos_l, neg_l, nc)
            pos_s, neg_s = out[:bl], out[bl:]
        else:
            nsp, nsn = (n // ndev for n in tr._split)
            small = body(pos_l[:, :nsp * c], neg_l[:, :nsn * c], nsp, cfg.k_small)
            big = body(pos_l[:, nsp * c:], neg_l[:, nsn * c:], nc - nsp)
            nbp = (nc - nsp) * c
            pos_s = torch.cat([small[:nsp * c], big[:nbp]])
            neg_s = torch.cat([small[nsp * c:], big[nbp:]])
        # the whole batch's scores on every rank; each rank's scores get
        # their own slice of the (common) cotangent
        all_pos = AllGatherRows.apply(pos_s, mesh.comm, mesh.dp_group, "slice")
        all_neg = AllGatherRows.apply(neg_s, mesh.comm, mesh.dp_group, "slice")
        if inv_p is not None:
            all_pos, all_neg = all_pos[inv_p], all_neg[inv_n]
        return tr._loss(all_pos, all_neg)

    def step(self, state, pos, neg, aux, gen, inv_p=None, inv_n=None):
        mesh = self.mesh
        loss = self.loss(state, pos, neg, aux, gen, inv_p, inv_n)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        # each rank's gradients cover its own compute path: their sum
        mesh.comm.sum_grads(list(state.encoder.parameters())
                            + list(state.predictor.parameters()),
                            mesh.dp_group, mesh.dp)
        average_ema(state, mesh)
        state.opt.step()
        return state, loss.detach()


def average_ema(state, mesh) -> None:
    """The predictor's float EMA buffers averaged over "dp" (the counters,
    integers, agree already)."""
    with torch.no_grad():
        for b in state.predictor.buffers():
            if b.is_floating_point() and mesh.dp > 1:
                b.copy_(mesh.comm.all_reduce(b, mesh.dp_group) / mesh.dp)


# --------------------------------------------------------------------------
# sharded eval
# --------------------------------------------------------------------------

class ShardedEval:
    """Eval with the graph sharded (port of make_sharded_encode,
    make_sharded_score and the Trainer's _sharded_scorers): the eval-mode
    encoder on the shards then one all-gather of h; the scorers against the
    sharded tables (the current refresh's ELL shards under ell_eval).
    ``use_valedges_as_input`` adds the train+valid graph's shards, scored
    without tables (and with the train graph's A^3, as on one device)."""

    def __init__(self, tr):
        self.tr = tr
        self.use_ell = bool(tr.cfg.ell_eval and tr._use_ell)
        self.main = _Shards(tr, tr.g, tr.adj2, tr.adj3, self.use_ell)
        self.full = None
        if tr.cfg.use_valedges_as_input and tr.full_g is not tr.g:
            self.full = _Shards(tr, tr.full_g, tr.full_adj2, tr.adj3, False)

    @torch.no_grad()
    def encode(self, state, full: bool = False) -> torch.Tensor:
        sh = self.full if full and self.full is not None else self.main
        state.encoder.eval()
        h_l = state.encoder(sh.x, sh.graph)
        mesh = self.tr.mesh
        return mesh.comm.all_gather(h_l, mesh.dp_group).reshape(
            -1, h_l.shape[-1])[:sh.n_nodes]

    @torch.no_grad()
    def scores(self, state, h, edges: np.ndarray, full: bool = False) -> np.ndarray:
        """Scores of (n, 2) edges in (2, bs) batches, bs a multiple of
        dp * chunk (the tail padded and value-masked); each rank scores its
        slice of a batch in chunks, and the scores are gathered."""
        tr = self.tr
        cfg, mesh = tr.cfg, tr.mesh
        ndev, me = mesh.dp, mesh.dp_rank
        sh = self.full if full and self.full is not None else self.main
        if sh.use_ell:
            ell = tr._ell
            ws = (sh.windows(0, ell["tbl1_sh"]), sh.windows(1, ell["tbl2_sh"]),
                  sh.windows(2, ell.get("tbl3_sh")))
        else:
            ws = (sh.windows(0), sh.windows(1), sh.windows(2))
        c = tr._chunk()
        unit = ndev * c
        bs = max(unit, (cfg.testbs // unit) * unit)
        bl = bs // ndev
        state.predictor.eval()
        out = []
        n = edges.shape[0]
        for start in range(0, n, bs):
            chunk = np.asarray(edges[start:start + bs]).T
            m = chunk.shape[1]
            if bs - m:
                chunk = np.concatenate([chunk, np.zeros((2, bs - m), chunk.dtype)], 1)
            valid = torch.zeros(bs, device=tr.device)
            valid[:m] = 1.0
            e = torch.as_tensor(chunk[:, me * bl:(me + 1) * bl], dtype=torch.int64,
                                device=tr.device)
            v = valid[me * bl:(me + 1) * bl]
            gen = torch.Generator(device=tr.device)
            gen.manual_seed(cfg.seed * 0x9E3779B1 + start * 0x85EBCA77 + me)
            local = torch.cat([
                tr._score_chunk(state, h, ws[0], e[:, i:i + c], v[i:i + c], gen,
                                False, ws[1], adj3=ws[2])
                for i in range(0, bl, c)])
            s = mesh.comm.all_gather(local, mesh.dp_group).reshape(-1)
            out.append(s[:m].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

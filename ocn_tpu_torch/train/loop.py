"""Training/eval engine (port of ocn_tpu/train/loop.py for every predictor,
cn1-cn9, under either encoder stack).

One training step:

* maskinput: the batch's target links are removed from the adjacency by
  zeroing its values at precomputed nnz positions (``edge2pos``);
* the encoder runs once over the masked graph;
* link scoring runs as a Python loop over fixed-size link chunks (the JAX
  package's ``lax.scan``), all positive chunks first and then all negative
  ones, which is the order the predictor's EMA inner product is updated in;
  positive chunks carry the maskinput self-path correction for A^2;
* the loss over all chunks is backpropagated once and a two-group Adam
  (gnnlr for the encoder, prelr for the predictor) takes a step.

Five layout options of the JAX package are ported:

* ELL tables (``ell_tables``): each epoch freezes the window offsets of the
  capped rows in (N, K) tables of g and A^2 (sparse/ell.py), rebuilt on the
  device; neighbor gathers become row gathers of the tables, and maskinput
  clears the batch edges in a copy of g's table;
* the dual-K split (``k_small``): each batch is sorted by source degree so
  the leading chunks, the low-degree majority, run at frame width k_small
  and the rest at pad_deg; EMA order becomes [pos_s, neg_s, pos_b, neg_b]
  and inverse permutations restore the batch order for the loss;
* the window table (``window_table``): y = h.detach()[g.col] is built once
  per step and the frame matmuls read contiguous windows of it through the
  window-gather kernel (ops/window_gather.py);
* grouped frames (``frame_group`` > 1): each body's chunks are scored in
  groups whose frames one cn_frames call builds (``_score_chunk``); the
  predictor still runs per chunk.  Eval is never grouped;
* hoisted frames (``hoist_frames``): the frames of the whole step, all
  2*batch_size links, in one cn_frames call, i.e. one frame group of every
  chunk of the step (it turns the dual-K split off).

``two_hop_mode="sddmm"`` builds no A^2 (and no A^3): cn_frames counts the
two-hop paths on the fly on the masked graph, cn6 takes cn3_frame's
on-the-fly fallback, and the ELL tables stay off (they need A^2), as in the
JAX package.  ``count2_chunk`` reaches no cn_frames call there either: the
JAX trainer does not pass it.

cn6 (THREE_HOP) adds a third frame from A^3 = A^2 @ A, built once on the
host and capped at adj3_cap per row, with its own ELL table (``tbl3``,
k3 wide); it is never grouped or hoisted, though the dual-K split still
rounds its small body to whole frame groups, as in the JAX package.

The incomplete family (cn2/cn3/cn4, SELF_BUILDING) builds its own frames
from (g, edges) in the predictor, per chunk: it takes no frame groups,
hoisting or window table.  Only cn3 gets an A^2; the ELL tables cover g
(and cn3's A^2), and the dual-K split routes low-degree chunks to an outer
width of k_small (at eval by the larger degree of both endpoints).
``rec_k`` -1 picks the recursion width from the graph (``_auto_rec_k``),
and ``increasealpha`` ramps the family's alpha2 (``TrainState.sched``) at
the start of each epoch.

``cndeg`` > 0 caps the frame-based CN sets by ``sample_frame`` (which
turns the window table's positions off: the sampled ids are no longer CSR
windows).

``dtype="bfloat16"`` keeps the node features and the valid/correction
planes in bfloat16; the first Dense promotes to float32 (nn/mlp.py), so
h, the frames and every parameter are float32, as in the JAX package.

The step is one program (train/step_graph.py, the port of the JAX
package's ``jax.jit`` of the step): on one CUDA device it is captured once
as a CUDA graph and replayed every step, its inputs copied into static
buffers; the mesh and node-sharded steps stay eager.  ``train_epoch`` keeps
each step's loss on the device and reads them all once, at the end of the
epoch, as the JAX loop does, so the host queues step k+1 while the card
runs step k.  Where the train graph is on a CUDA device, the epoch's
uniform negatives are drawn there from its CSR (ops/negatives.py), the
host sampler's links and draws from the same stream, bit for bit.

Randomness (dropout, DropAdj, window offsets of capped rows off the tables)
comes from the trainer's one ``torch.Generator`` (the step program's),
reseeded each epoch from the host NumPy generator that also draws the
batch permutation and negatives, exactly as ocn_tpu draws its PRNG key;
the ELL offsets come from a NumPy generator derived from the epoch number.
``evaluate`` gives Hits@K, ``evaluate_mrr`` the citation2 MRR.

Multi-device (``dp_devices * tp_devices > 1``): the Trainer is made in each
rank of a running process group (parallel/launch.py) and builds the dp x tp
mesh (parallel/mesh.py).

* ``graph_sharding="replicated"``, the mesh step: the single-device step
  on dp x tp ranks (the JAX package's GSPMD branch).  Every rank holds the
  graph and runs the encoder; each link chunk is split into dp row blocks
  and h into tp column blocks (parallel/shard.py: the chunk-wide column
  sums, inner products and maxima reduce over "dp", every draw is the
  single-device draw, the first Dense reading h is row-parallel); the
  scores are gathered for the loss, and gradients are summed over the ranks
  that computed disjoint parts of them.  Eval runs on every rank as on one
  device.
* ``graph_sharding="node"``: node-sharded training and eval
  (parallel/sharded_graph.py): adjacency, A^2 (and A^3), the window or ELL
  tables and the features live on the device as row-range shards; each
  rank scores its own chunks of the batch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ocn_tpu_torch.config import Config, require_supported
from ocn_tpu_torch.data.loaders import LinkDataset
from ocn_tpu_torch.nn.encoder import GCNEncoder
from ocn_tpu_torch.nn.predictors import (
    FRAME_BASED, SELF_BUILDING, THREE_HOP, build_predictor)
from ocn_tpu_torch.ops.frame import CNFrame, cn3_frame, cn_frames
from ocn_tpu_torch.ops.negatives import negatives
from ocn_tpu_torch.ops.sample import sample_frames
from ocn_tpu_torch.parallel import shard
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse import ell as ELL
from ocn_tpu_torch.sparse.csr import Graph, graph_from_numpy
from ocn_tpu_torch.train import losses as L
from ocn_tpu_torch.train import metrics as M
from ocn_tpu_torch.train import step_graph


def resolve_device(device) -> torch.device:
    """The torch device for an entry point; a CUDA request without a card
    raises instead of dropping to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ocn_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def epoch_ell_rng(epoch: int) -> np.random.Generator:
    """The generator train_epoch draws the ELL tables' offsets from at
    ``epoch`` (derived from the epoch alone, as in the JAX package).  The
    tables belong to the trainer, not to the TrainState: a state restored
    from a checkpoint evaluates as it did when saved once the tables are
    rebuilt from this generator of the saved epoch."""
    return np.random.default_rng((epoch * 0x9E3779B1 + 0x85EBCA77) & 0xFFFFFFFF)


def _largest_divisor_leq(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target`` (the link chunk must
    divide batch_size exactly); warns when it collapses far below target."""
    target = max(1, min(n, target))
    for c in range(target, 0, -1):
        if n % c == 0:
            if c * 2 <= target:
                warnings.warn(
                    f"batch_size {n} has no divisor near the requested link "
                    f"chunk {target}; falling back to chunk {c} "
                    f"({n // c} chunks). Pick a batch_size divisible by "
                    "the chunk size (e.g. a multiple of 4096).",
                    RuntimeWarning, stacklevel=2,
                )
            return c
    return 1


def _group_size(n: int, frame_group: int) -> int:
    """Chunks per frame group in a body of ``n`` chunks: the largest divisor
    of n that is <= frame_group (the JAX package's eff_grp)."""
    for d in range(max(min(n, frame_group), 1), 0, -1):
        if n % d == 0:
            return d
    return 1


@dataclasses.dataclass
class TrainState:
    """The modules (parameters and the predictor's EMA buffers) and the
    optimizer.  Steps update it in place and return it."""

    encoder: GCNEncoder
    predictor: torch.nn.Module
    opt: torch.optim.Optimizer

    @property
    def sched(self) -> Dict[str, torch.Tensor]:
        """The predictor's schedule state (the JAX package's "sched"
        collection): the incomplete family's alpha2 buffer, else empty."""
        alpha2 = getattr(self.predictor, "alpha2", None)
        return {} if alpha2 is None else {"alpha2": alpha2}


def _auto_rec_k(ds: LinkDataset, pad_deg: int) -> int:
    """The recursion width for rec_k = -1: the smallest power of two, from
    8, that covers the 75th percentile of the degrees of edge endpoints
    (neighbor-of sampling, so size-biased), at most pad_deg."""
    deg = np.bincount(np.asarray(ds.edge_index[0]), minlength=ds.n_nodes)
    ep = deg[np.asarray(ds.edge_index[1])]
    q = float(np.quantile(ep, 0.75)) if ep.size else 8.0
    r = 8
    while r < min(pad_deg, q):
        r *= 2
    return min(r, pad_deg)


class Trainer:
    """Drives one (dataset, config) pair on one device, or on one rank of a
    dp x tp mesh (the process group must be running).

    ``capture``: on one CUDA device the step is captured as a CUDA graph and
    replayed (train/step_graph.py); False runs the same program eagerly, op
    by op (the card tests' and chip_smoke.py's reference).  The mesh and
    node-sharded steps are eager either way."""

    def __init__(self, cfg: Config, ds: LinkDataset, device="cuda",
                 capture: bool = True):
        require_supported(cfg)
        self.cfg = cfg
        self.ds = ds
        self.device = resolve_device(device)
        self.frame_based = cfg.predictor in FRAME_BASED
        self.mesh = None
        if cfg.dp_devices * cfg.tp_devices > 1:
            from ocn_tpu_torch.parallel.mesh import make_mesh
            self.mesh = make_mesh(cfg.dp_devices, cfg.tp_devices, self.device)
        # node sharding: the whole graph stays on the host, each rank's
        # device gets its row-range shards (parallel/sharded_graph.py)
        self.sharded = cfg.graph_sharding == "node" and self.mesh is not None
        # the weights the mesh step ran row-parallel (parallel/shard.py)
        self._tp_weights = set()
        self._graph_device = torch.device("cpu") if self.sharded else self.device
        if cfg.rec_k < 0 and cfg.predictor in SELF_BUILDING:
            # written back into cfg, as the JAX package does
            cfg.rec_k = _auto_rec_k(ds, cfg.pad_deg)
        g_host = ds.as_graph()
        self.g = g_host.to(self._graph_device)
        full_host = ds.full_graph() if ds.full_edge_index is not None else None
        self.full_g = (full_host.to(self._graph_device) if full_host is not None
                       else self.g)
        # "bfloat16" stores the node features and the valid/correction
        # planes in bfloat16; parameters, h and the frames stay float32
        # (nn/mlp.py Dense), as in the JAX package
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        xdev = self._graph_device
        if ds.max_x >= 0:
            self.x = torch.as_tensor(ds.x, dtype=torch.int64, device=xdev)
        else:
            self.x = torch.as_tensor(ds.x, dtype=self.dtype, device=xdev)

        # precomputed A^2 for the "gather" two-hop mode: one host SpGEMM per
        # graph instead of the reference's per-batch SpGEMM (of the
        # incomplete family only cn3 reads one)
        self.adj2 = self.full_adj2 = None
        self.adj2_seconds = 0.0
        if cfg.two_hop_mode == "gather" and (self.frame_based
                                             or cfg.predictor == "cn3"):
            t0 = time.perf_counter()
            self.adj2 = self._build_adj2(g_host,
                                         keep_host=cfg.predictor in THREE_HOP)
            self.full_adj2 = (self._build_adj2(full_host)
                              if full_host is not None else self.adj2)
            self.adj2_seconds = time.perf_counter() - t0
        # cn6: A^3 = A^2 @ A once per (train) graph, so its 3-hop counts are
        # one row gather and one membership lookup per chunk
        self.adj3 = None
        self.adj3_seconds = 0.0
        if cfg.predictor in THREE_HOP and self.adj2 is not None:
            t0 = time.perf_counter()
            self.adj3 = self._build_adj3(g_host)
            self.adj3_seconds = time.perf_counter() - t0
        # host degrees of A^2 and A^3 for the ELL offsets: a refresh reads
        # nothing back from the card
        self._deg2_np, self._deg3_np = (
            None if a is None else a.deg.cpu().numpy() for a in (self.adj2, self.adj3))

        # maskinput: train-edge -> nnz position map, once per dataset
        self.train_edges = np.asarray(ds.split_edge["train"]["edge"]).T  # (2, E)
        self.edge2pos = None
        if cfg.maskinput:
            self.edge2pos = np.asarray(B.edge_to_nnz_positions(
                g_host.indptr.numpy(), g_host.col.numpy(), self.train_edges))

        self._deg_np = g_host.deg.numpy()
        self._indptr_np = g_host.indptr.numpy()
        self._split = self._split_plan()
        # ELL window tables: built by the first train_epoch (or an explicit
        # _refresh_ell) and rebuilt every cfg.ell_refresh epochs
        self._ell = None
        # the frame-based predictors need both tables; the incomplete family
        # gathers g (and cn3 its A^2) inside the predictor, recursion
        # included, and takes the tables whenever its graphs pack
        a2_packs = self.adj2 is not None and self.adj2.packed is not None
        self._use_ell = bool(
            cfg.ell_tables and self.g.packed is not None
            and ((self.frame_based and a2_packs)
                 or (cfg.predictor in SELF_BUILDING
                     and (self.adj2 is None or a2_packs))))
        # the one generator of the training steps, reseeded each epoch, and
        # the single-device step as one program (captured on the card)
        self.gen = torch.Generator(device=self.device)
        self._program = None
        if self.mesh is None:
            self._program = step_graph.StepProgram(
                self._step, self.gen,
                capture=capture and step_graph.captures(cfg, self.device))

    def _build_adj2(self, g: Graph, keep_host: bool = False) -> Graph:
        ip = g.indptr.numpy()
        col = g.col.numpy()[: int(ip[-1])]
        ip2, col2, val2 = B.adj2_csr(ip, col, g.n_nodes, cap=self.cfg.adj2_cap)
        if keep_host:  # the host CSR feeds cn6's A^3 SpGEMM
            self._adj2_host = (ip2, col2, val2)
        # consumed only through window gathers: upload indptr/deg and the
        # packed entries (4 bytes each), or col/val where counts do not pack;
        # node sharding slices col/val on the host (the full layout, as in
        # the JAX package)
        return graph_from_numpy(
            ip2, col2, g.n_nodes, val2,
            gather_only=self.cfg.graph_sharding != "node").to(self._graph_device)

    def _build_adj3(self, g: Graph) -> Graph:
        """The row-capped A^3 = A^2 @ A (host SpGEMM, capped at adj3_cap),
        gather-only on the device like A^2."""
        ip = g.indptr.numpy()
        col = g.col.numpy()[: int(ip[-1])]
        ip2, col2, val2 = self._adj2_host
        del self._adj2_host
        n2 = int(ip2[-1])
        ip3, col3, val3 = B.spgemm_csr(ip2, col2[:n2], val2[:n2], ip, col, None,
                                       g.n_nodes, cap=self.cfg.adj3_cap)
        return graph_from_numpy(
            ip3, col3, g.n_nodes, val3,
            gather_only=self.cfg.graph_sharding != "node").to(self._graph_device)

    def _k3_width(self) -> int:
        """Width of cn6's A^3 row gather and of its ELL table: Config.k3, or
        min(pad_deg2, 16)."""
        if self.cfg.k3 > 0:
            return self.cfg.k3
        return min(self.cfg.pad_deg2, 16)

    def _sharded_ell_k1(self) -> int:
        """Width of the node-sharded g table: it serves the src gather
        (pad_deg, or k_small) and the dst gather (pad_deg2_dst or pad_deg2),
        since the sharded path has no CSR-window fallback."""
        return max(self.cfg.pad_deg, self.cfg.pad_deg2_dst or self.cfg.pad_deg2)

    def _chunk_interleave(self) -> Tuple[np.ndarray, np.ndarray]:
        """(positive, negative) column permutations, transmitted -> degree
        sorted, for the node-sharded dual-K split: rank d's contiguous slice
        of the batch holds nsp/ndev small chunks, then nbp/ndev big ones."""
        if getattr(self, "_ichunk", None) is None:
            c = self._chunk()
            nchunk = self.cfg.batch_size // c
            ndev = self.cfg.dp_devices

            def perm(n_small: int) -> np.ndarray:
                nsl, nbl = n_small // ndev, (nchunk - n_small) // ndev
                order = []
                for d in range(ndev):
                    order += list(range(d * nsl, (d + 1) * nsl))
                    order += list(range(n_small + d * nbl, n_small + (d + 1) * nbl))
                return (np.asarray(order, np.int64)[:, None] * c
                        + np.arange(c)).reshape(-1)

            nsp, nsn = self._split
            self._ichunk = (perm(nsp), perm(nsn))
        return self._ichunk

    def _refresh_ell(self, rng: np.random.Generator) -> None:
        """Re-draw the frozen window offsets on the host and rebuild the
        ELL tables (g at pad_deg, A^2 at pad_deg2 where there is one, cn6's
        A^3 at k3, whose offsets are drawn last) on the device, in place
        once they exist: the step program reads them at fixed addresses.
        Node-sharded: the tables are built on the host and only this rank's
        row-range shards go to the device (parallel/sharded_graph.py)."""
        cfg = self.cfg
        if self.sharded:
            from ocn_tpu_torch.parallel.sharded_graph import refresh_sharded_ell
            self._ell = refresh_sharded_ell(self, rng)
            return
        ell = {}
        off1 = ELL.draw_offsets(self._deg_np, cfg.pad_deg, rng)
        o1 = torch.as_tensor(off1, device=self.device)
        ell.update(tbl1=ELL.build_ell(self.g.packed, self.g.indptr, o1, cfg.pad_deg),
                   off1=o1)
        if self.adj2 is not None:
            o2 = torch.as_tensor(ELL.draw_offsets(self._deg2_np, cfg.pad_deg2, rng),
                                 device=self.device)
            ell.update(tbl2=ELL.build_ell(self.adj2.packed, self.adj2.indptr, o2,
                                          cfg.pad_deg2), off2=o2)
        if self.adj3 is not None:
            k3 = self._k3_width()
            o3 = torch.as_tensor(ELL.draw_offsets(self._deg3_np, k3, rng),
                                 device=self.device)
            ell.update(tbl3=ELL.build_ell(self.adj3.packed, self.adj3.indptr, o3, k3),
                       off3=o3)
        if self._ell is None:
            self._ell = ell
        else:
            for name, t in ell.items():
                self._ell[name].copy_(t)
        self._ell["off1_np"] = off1

    def _split_plan(self) -> Optional[Tuple[int, int]]:
        """Chunk counts (n_small_pos, n_small_neg) of the dual-K split, or
        None when it is off.  Sorting each batch by source degree puts the
        low-degree majority in the leading chunks, so a fixed boundary at
        the degree distribution's quantile routes almost exactly the
        deg <= k_small edges to the small body; edges that spill into it get
        the usual deg/k reweighted cap.  With frame_group > 1 the small
        body's chunk count nsp + nsn is rounded down to whole groups (taking
        from the larger side, negatives on a tie), which moves chunks to the
        big body and caps no extra edge.  The incomplete family joins the
        split too (its outer width takes k_small); cn6 and the family, which
        are never grouped, still round to whole groups, as in the JAX
        package."""
        cfg = self.cfg
        if cfg.k_small <= 0 or cfg.k_small >= cfg.pad_deg or cfg.hoist_frames:
            return None
        if self.sharded and cfg.predictor in SELF_BUILDING:
            # the node-sharded step covers the frame-based predictors only
            return None
        nchunk = cfg.batch_size // self._chunk()
        deg = self._deg_np
        if cfg.small_frac >= 0:
            fp = cfg.small_frac
        else:
            fp = float(np.mean(deg[self.train_edges[0]] <= cfg.k_small))
        if cfg.small_frac_neg >= 0:
            fneg = cfg.small_frac_neg
        elif cfg.neg_mode == "randint_target":
            fneg = fp  # negatives keep the positive sources
        else:
            fneg = float(np.mean(deg <= cfg.k_small))
        nsp = min(nchunk, int(fp * nchunk))
        nsn = min(nchunk, int(fneg * nchunk))
        if self.sharded:
            # each rank gets nsp/ndev small and nbp/ndev big chunks (the
            # round-robin interleave of prepare_batch): round each side down
            # to a multiple of ndev, which moves low-degree chunks to the big
            # body and caps no extra edge; no frame groups there
            ndev = cfg.dp_devices
            nsp -= nsp % ndev
            nsn -= nsn % ndev
            return (nsp, nsn) if nsp + nsn else None
        grp = max(cfg.frame_group, 1)
        while nsp + nsn > 0 and (nsp + nsn) % grp:
            if nsn >= nsp and nsn > 0:
                nsn -= 1
            else:
                nsp -= 1
        if nsp + nsn == 0:
            return None
        return nsp, nsn

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int) -> TrainState:
        """Fresh modules initialised from ``seed`` (flax's default
        initialisers) and a two-group Adam."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(seed)
        encoder = GCNEncoder(
            in_features=self.ds.num_features, hidden=cfg.hiddim,
            num_layers=cfg.mplayers, dropout=cfg.gnndp, ln=cfg.ln, res=cfg.res,
            max_x=self.ds.max_x, conv_fn=cfg.model, jk=cfg.jk,
            edrop=cfg.gnnedp, xdropout=cfg.xdp, taildropout=cfg.tdp,
            noinputlin=cfg.loadx, stack=cfg.encoder_stack)
        encoder.reset_parameters(gen)
        predictor = build_predictor(cfg.predictor, cfg.hiddim, cfg.hiddim,
                                    n_nodes=self.ds.n_nodes,
                                    **cfg.predictor_kwargs())
        predictor.reset_parameters(gen)
        encoder.to(self.device)
        predictor.to(self.device)
        # capturable on the card: its step count and bias corrections stay
        # on the device, so the step can be captured, and the eager step runs
        # the same kernels
        opt = torch.optim.Adam([
            {"params": list(encoder.parameters()), "lr": cfg.gnnlr},
            {"params": list(predictor.parameters()), "lr": cfg.prelr},
        ], betas=(0.9, 0.999), eps=1e-8, capturable=self.device.type == "cuda")
        return TrainState(encoder, predictor, opt)

    # ------------------------------------------------------- chunked scoring
    def _chunk(self) -> int:
        cfg = self.cfg
        target = cfg.linkbatchsize if cfg.linkbatchsize > 0 else 4096
        return _largest_divisor_leq(cfg.batch_size, target)

    def _score_chunk(self, state: TrainState, h, g: Graph, edges, valid, gen,
                     training: bool, adj2: Optional[Graph], corr=None, y=None,
                     k: Optional[int] = None, grp: int = 1,
                     adj3: Optional[Graph] = None,
                     share: Optional[Tuple[torch.Tensor, int]] = None
                     ) -> torch.Tensor:
        """Score ``grp`` chunks of C links, (2, grp*C) edges; returns
        (grp*C,) scores.  ``corr``: (grp*C,) maskinput self-path correction
        (1 for positive train edges whose (i, j) was just masked out).  In
        eval, ``gen`` samples capped rows when cfg.eval_sampling (else the
        first-k window).  ``y``: the window table h.detach()[g.col] (the
        frame matmul then reads the candidate frame's CSR windows of it).
        ``k``: candidate-frame width (the dual-K small body), default
        pad_deg.  ``adj2`` None: the "sddmm" mode.  ``adj3``: cn6's A^3 (its
        third frame, cn3_frame; None takes the on-the-fly fallback).

        ``grp`` > 1 is the port of _scan_scores_grouped (and, a group of
        every chunk of the step, of _scan_scores_hoisted): one cn_frames call
        builds the frames of the whole group (two membership launches at
        grp*C rows), then the predictor runs once per chunk on its row
        slice, so column normalisation stays per chunk and the EMA advances
        chunk by chunk.  One generator serves both, so the group draws its
        capped-row windows once and each chunk its dropout, in that order;
        the streams cannot equal JAX's fold_in keys.

        The incomplete family (grp 1) passes the chunk to its predictor,
        ``gen`` as both its dropout and its sample stream in training and,
        when cfg.eval_sampling, as its sample stream at eval; it reads
        neither ``valid`` nor ``corr``, as in the JAX package.  ``cndeg``
        caps the frame-based CN sets, both from one draw of the group.

        ``share`` (rows, full chunk size): in the mesh step each chunk here
        is this rank's rows of a full chunk (_mesh_group), and the predictor
        runs with them as its RowShard (parallel/shard.py)."""
        cfg = self.cfg
        frame_gen = gen if (training or cfg.eval_sampling) else None
        if not self.frame_based:
            out = state.predictor(h, g, edges, gen=gen if training else None,
                                  sample=frame_gen, adj2=adj2,
                                  k=k or cfg.pad_deg)
            return out.reshape(-1)
        cn1, cn2, src = cn_frames(
            g, edges, k=k or cfg.pad_deg, k2=cfg.pad_deg2, gen=frame_gen,
            adj2=adj2, self_corr=corr, k2_dst=cfg.pad_deg2_dst,
            cn2_counts=cfg.cn2_counts, exact_two_hop=cfg.exact_two_hop,
            with_src=True)
        if cfg.cndeg > 0:
            # the sampled ids are no CSR windows: no window-table positions
            cn1, cn2 = sample_frames([cn1, cn2], cfg.cndeg, frame_gen)
            y = None
        frames = [cn1, cn2]
        if cfg.predictor in THREE_HOP:
            # cn3 shares the candidate frame src of cn1 and cn2
            k3 = self._k3_width()
            frames.append(cn3_frame(g, edges, src, k2=k3, k3=k3,
                                    counts=cfg.cn2_counts, adj3=adj3))
        # padded/invalid edges must not pollute batch column sums / EMA
        frames = [f.with_values(f.val * valid[:, None]) for f in frames]
        c = edges.shape[1] // grp
        outs = []
        for j in range(grp):
            sl = slice(j * c, (j + 1) * c)
            with (shard.rows(self.mesh, *share, self._tp_weights, self.cfg.hiddim)
                  if share is not None else contextlib.nullcontext()):
                out = state.predictor(
                    h, g.n_nodes, *[CNFrame(f.ids[sl], f.val[sl], g.n_nodes)
                                    for f in frames], edges[:, sl],
                    gen if training else None, y=y,
                    pos=src.pos[sl] if y is not None else None)
            outs.append(out.reshape(-1))
        return torch.cat(outs) if grp > 1 else outs[0]

    def _loss(self, pos_out, neg_out):
        cfg = self.cfg
        return L.LOSSES[cfg.losstrick](
            pos_out, neg_out, num_neg=1, weight=cfg.lossweight,
            margin=cfg.lossmargin)

    # ------------------------------------------------------------ train step
    def _masked_graph(self, mask_positions) -> Graph:
        """The train graph of one step.  ``mask_positions``: None, (P,) CSR
        positions, or the dict of prepare_batch with the ELL tables: g then
        carries its table with the batch edges cleared in a copy of it."""
        if mask_positions is None:
            return self.g
        if isinstance(mask_positions, dict):
            mp = mask_positions
            g = self.g.mask_edges(mp["csr"]) if mp["csr"] is not None else self.g
            tbl = mp["ell1"]
            if "ell_flat" in mp:
                tbl = ELL.apply_ell_mask(tbl, mp["ell_flat"], mp["ell_cleared"])
            return g.with_ell(tbl, mp["off1"])
        return self.g.mask_edges(mask_positions)

    def _local_adj2(self, mask_positions) -> Optional[Graph]:
        """A^2 of one step: no maskinput edit (cn_frames' self-path
        correction handles it), but its gathers ride the ELL table when the
        tables are on."""
        if isinstance(mask_positions, dict) and "ell2" in mask_positions:
            return self.adj2.with_ell(mask_positions["ell2"],
                                      mask_positions["off2"])
        return self.adj2

    def _local_adj3(self, mask_positions) -> Optional[Graph]:
        """cn6's A^3 of one step: no maskinput edit either, its gathers ride
        the ELL table when the tables are on."""
        if self.adj3 is not None and isinstance(mask_positions, dict):
            return self.adj3.with_ell(mask_positions["ell3"],
                                      mask_positions["off3"])
        return self.adj3

    def step_loss(self, state: TrainState, pos: torch.Tensor, neg: torch.Tensor,
                  mask_positions, gen: torch.Generator,
                  inv_p: Optional[torch.Tensor] = None,
                  inv_n: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training loss of one batch, with its autograd graph: the
        encoder over the masked graph, then every positive chunk and every
        negative chunk in order (with the dual-K split: the small body's
        positive and negative chunks, then the big body's), in frame groups
        of up to frame_group chunks, or with hoist_frames in one group of
        them all (cn6 and the incomplete family are never grouped).  Steps
        the predictor's EMA buffers."""
        cfg = self.cfg
        c = self._chunk()
        b = pos.shape[1]
        nchunk = b // c
        split = self._split
        if split is not None and (inv_p is None or inv_n is None):
            raise ValueError("k_small > 0 needs degree-sorted batches; build "
                             "the step inputs with Trainer.prepare_batch")
        g = self._masked_graph(mask_positions)
        adj2 = self._local_adj2(mask_positions)
        adj3 = self._local_adj3(mask_positions)
        state.encoder.train()
        state.predictor.train()
        h = state.encoder(self.x, g, gen)
        if self.mesh is not None and self.mesh.tp > 1:
            # the predictor holds this rank's tp column share of h
            w = h.shape[-1] // self.mesh.tp
            h = h[:, self.mesh.tp_rank * w:(self.mesh.tp_rank + 1) * w]
        # the window table: one CSR-order row gather per step; the gradient
        # to h flows through the frame matmuls' backward, not through y
        y = h.detach()[g.col] if self._window_table() else None

        def score(edges, n_pos, k=None):
            return self._score_body(state, h, g, edges, n_pos, gen, adj2, adj3,
                                    y=y, k=k, split=self.mesh is not None)

        if split is None:
            out = score(torch.cat([pos, neg], dim=1), nchunk)
            return self._loss(out[:b], out[b:])
        nsp, nsn = split
        small = score(torch.cat([pos[:, :nsp * c], neg[:, :nsn * c]], dim=1),
                      nsp, k=cfg.k_small)
        big = score(torch.cat([pos[:, nsp * c:], neg[:, nsn * c:]], dim=1),
                    nchunk - nsp)
        nbp = (nchunk - nsp) * c
        pos_sorted = torch.cat([small[:nsp * c], big[:nbp]])
        neg_sorted = torch.cat([small[nsp * c:], big[nbp:]])
        # the original batch order, so per-index pos/neg pairing survives
        return self._loss(pos_sorted[inv_p], neg_sorted[inv_n])

    def _score_body(self, state: TrainState, h, g, edges, n_pos: int, gen,
                    adj2, adj3, y=None, k: Optional[int] = None,
                    grouped: bool = True, split: bool = False) -> torch.Tensor:
        """Training scores of a body of (2, n*C) edges, the first ``n_pos``
        chunks positive, in groups of _group_size(n, frame_group) chunks, or
        hoisted (one group of all n); ``grouped=False`` scores chunk by
        chunk.  ``split``: the mesh step (_mesh_group)."""
        cfg = self.cfg
        c = self._chunk()
        n = edges.shape[1] // c
        if cfg.predictor in THREE_HOP or not self.frame_based or not grouped:
            grp = 1
        elif cfg.hoist_frames:
            grp = max(n, 1)
        else:
            grp = _group_size(n, cfg.frame_group)
        valid = torch.ones(grp * c, dtype=self.dtype, device=self.device)
        score = self._mesh_group if split else self._score_chunk
        out = []
        for i in range(0, n, grp):
            # positive chunks lead the body, so a group's are a prefix
            npos = min(max(n_pos - i, 0), grp)
            corr = None
            if cfg.maskinput and npos:
                corr = valid if npos == grp else torch.cat(
                    [valid[:npos * c], torch.zeros_like(valid[npos * c:])])
            out.append(score(state, h, g, edges[:, i * c:(i + grp) * c], valid,
                             gen, True, adj2, corr=corr, y=y, k=k, grp=grp,
                             adj3=adj3))
        return torch.cat(out) if out else h.new_zeros(0)

    def _mesh_group(self, state: TrainState, h, g, edges, valid, gen, training,
                    adj2, corr=None, y=None, k=None, grp=1, adj3=None):
        """_score_chunk of a group in the mesh step: this rank scores its
        dp row block of each of the group's chunks, with the group's draws
        and chunk-wide reductions those of the single-device step
        (parallel/shard.py), and the scores are gathered over "dp" back into
        the group's order.  Every rank computes the same loss from them, so
        each rank's scores get their own slice of its cotangent."""
        from ocn_tpu_torch.parallel.launch import AllGatherRows

        mesh = self.mesh
        c = edges.shape[1] // grp
        if c % mesh.dp:
            raise ValueError(f"link chunk {c} does not split over dp={mesh.dp}")
        cl = c // mesh.dp
        lane = torch.arange(cl, device=edges.device) + mesh.dp_rank * cl
        idx = (torch.arange(grp, device=edges.device)[:, None] * c + lane).reshape(-1)
        with shard.rows(mesh, idx, grp * c, self._tp_weights, self.cfg.hiddim):
            local = self._score_chunk(
                state, h, g, edges[:, idx], valid[idx], gen, training, adj2,
                corr=None if corr is None else corr[idx], y=y, k=k, grp=grp,
                adj3=adj3, share=(lane, c))
        if mesh.dp == 1:
            return local
        out = AllGatherRows.apply(local, mesh.comm, mesh.dp_group, "slice")
        return out.reshape(mesh.dp, grp, cl).transpose(0, 1).reshape(-1)

    def _sync_mesh_grads(self, state: TrainState) -> None:
        """Sum the gradients of the mesh step over the ranks that computed
        disjoint parts of them: the encoder's and the row-parallel weights'
        over every rank (each rank's h cotangent covers its rows and its
        columns), the rest of the predictor's over "dp" (the tp ranks of a
        row block compute it alike)."""
        mesh = self.mesh
        world = list(state.encoder.parameters())
        dp_only = []
        for p in state.predictor.parameters():
            (world if id(p) in self._tp_weights else dp_only).append(p)
        mesh.comm.sum_grads(world, None, mesh.size)
        mesh.comm.sum_grads(dp_only, mesh.dp_group, mesh.dp)

    def row_parallel_names(self, state: TrainState):
        """Names (as in ``state.predictor.state_dict()``) of the weights the
        mesh step computed row-parallel so far (weights.tp_shard)."""
        return {name for name, p in state.predictor.named_parameters()
                if id(p) in self._tp_weights}

    def _window_table(self) -> bool:
        """The window table serves the frame-based predictors' CSR windows
        only: not the incomplete family, not cndeg-sampled frames."""
        cfg = self.cfg
        return cfg.window_table and self.frame_based and cfg.cndeg <= 0

    def train_step(self, state: TrainState, pos: torch.Tensor, neg: torch.Tensor,
                   mask_positions, gen: torch.Generator,
                   inv_p: Optional[torch.Tensor] = None,
                   inv_n: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step on the inputs of ``prepare_batch`` (positive
        and negative (2, batch_size) edges, mask positions, and with the
        dual-K split the inverse permutations); returns (state, detached
        loss).  On one device it runs through the step program (captured
        on the card); its loss is the caller's to keep."""
        if self.sharded:
            return self._sharded_train().step(state, pos, neg, mask_positions,
                                              gen, inv_p, inv_n)
        if self._program is None:
            return state, self._step(state, pos, neg, mask_positions, gen,
                                     inv_p, inv_n)
        return state, self._program.run(state, pos, neg, mask_positions, gen,
                                        inv_p, inv_n)

    def _step(self, state: TrainState, pos, neg, mask_positions, gen,
              inv_p=None, inv_n=None) -> torch.Tensor:
        """The eager step: loss, backward, (mesh) gradient sums, Adam;
        returns the detached loss.  The step program calls it on its
        buffers: to warm up, to capture and off the card."""
        loss = self.step_loss(state, pos, neg, mask_positions, gen, inv_p, inv_n)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            self._sync_mesh_grads(state)
        state.opt.step()
        return loss.detach()

    def _sharded_train(self):
        """The node-sharded train step of this rank (built on first use)."""
        if getattr(self, "_sg_step", None) is None:
            from ocn_tpu_torch.parallel.sharded_graph import ShardedGraphStep
            self._sg_step = ShardedGraphStep(self)
        return self._sg_step

    # ------------------------------------------------------------- epoch API
    def prepare_batch(self, pos_b: np.ndarray, neg_b: np.ndarray,
                      idx: Optional[np.ndarray] = None):
        """Host-side step inputs: ``pos_b``/``neg_b`` (2, B) int edge arrays,
        ``idx`` (B,) indices into the train-edge list (for maskinput).

        With the dual-K split each side is stable-sorted by source degree
        and the inverse permutations restore the original order of the
        scores.  With ELL tables the mask positions become a dict: the CSR
        positions, the current tables, and the batch edges' positions inside
        the frozen windows with the cleared entries to write there.
        Returns (pos, neg, mask_positions, inv_p, inv_n) as device tensors
        (None where they do not apply).

        Node-sharded: the degree sort is followed by the round-robin chunk
        interleave (_chunk_interleave), so the inverse permutations map
        original to transmitted positions; the mask positions stay on the
        host (the CSR positions, or a dict with the ELL flat positions at the
        sharded table's width), for the step to route to each rank."""
        dev = self.device
        inv_p = inv_n = None
        if self._split is not None:
            ar = np.arange(pos_b.shape[1])
            sp = np.argsort(self._deg_np[pos_b[0]], kind="stable")
            sn = np.argsort(self._deg_np[neg_b[0]], kind="stable")
            if self.sharded:
                cp, cpn = self._chunk_interleave()
                sp, sn = sp[cp], sn[cpn]
            pos_b, neg_b = pos_b[:, sp], neg_b[:, sn]
            if idx is not None:
                idx = idx[sp]
            inv = np.empty_like(sp)
            inv[sp] = ar
            inv_p = torch.as_tensor(inv, dtype=torch.int64, device=dev)
            inv = np.empty_like(sn)
            inv[sn] = ar
            inv_n = torch.as_tensor(inv, dtype=torch.int64, device=dev)
        mp = mp_np = None
        if self.edge2pos is not None and idx is not None:
            mp_np = np.maximum(self.edge2pos[idx].reshape(-1), 0)
            mp = torch.as_tensor(mp_np, dtype=torch.int64, device=dev)
        if self.sharded:
            mp = mp_np
            if self._ell is not None and mp_np is not None:
                flat, cleared = ELL.mask_ell_flat_positions(
                    pos_b, mp_np, self._indptr_np, self._ell["off1_np"],
                    self._sharded_ell_k1())
                mp = {"csr": mp_np, "ell_flat": flat, "ell_cleared": cleared}
        elif self._ell is not None:
            ell = self._ell
            aux = {"csr": mp, "ell1": ell["tbl1"], "off1": ell["off1"]}
            if "tbl2" in ell:  # no A^2 for cn2/cn4
                aux.update(ell2=ell["tbl2"], off2=ell["off2"])
            if "tbl3" in ell:  # cn6's A^3 table
                aux.update(ell3=ell["tbl3"], off3=ell["off3"])
            if mp_np is not None:
                flat, cleared = ELL.mask_ell_flat_positions(
                    pos_b, mp_np, self._indptr_np, ell["off1_np"],
                    self.cfg.pad_deg)
                aux["ell_flat"] = torch.as_tensor(flat, device=dev)
                aux["ell_cleared"] = torch.as_tensor(cleared, device=dev)
            mp = aux
        return (
            torch.as_tensor(np.asarray(pos_b), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(neg_b), dtype=torch.int64, device=dev),
            mp, inv_p, inv_n,
        )

    def _graph_negatives(self, num: int, rng: np.random.Generator) -> np.ndarray:
        """(2, num) uniform negatives drawn from the train graph's CSR where
        it lies (ops/negatives.py): ``B.negative_sampling``'s links for the
        same ``rng``, which draws the same seed from it (the train CSR holds
        the pairs of ``ds.edge_index``, both directions).  A draw whose
        candidates run out (``negatives.short``) takes the host sampler's
        second stage, as there: its NumPy rounds draw on from the stream, on
        the host, and fill the ``num`` links or raise its error.  A draw on
        the card is copied once to the host, for ``prepare_batch``'s host
        sort, and its device copy freed before the epoch's first step."""
        n = self.ds.n_nodes
        drawn = negatives(self.g.indptr, self.g.col, n, num, B.negative_seed(rng))
        if drawn.shape[1] < num:
            return B.rejection_rounds(B.edge_keys(self.ds.edge_index, n), n, num, rng)
        return drawn.cpu().numpy()

    def train_epoch(self, state: TrainState, rng: np.random.Generator,
                    epoch: int) -> Tuple[TrainState, float]:
        """One pass over the train edges in shuffled full batches (the ragged
        tail is dropped, as the reference's PermIterator does); returns the
        mean batch loss.  The losses stay on the device until the epoch
        ends and are read back in one transfer."""
        cfg = self.cfg
        if self._use_ell and (
                self._ell is None or (epoch - 1) % max(cfg.ell_refresh, 1) == 0):
            # a generator derived from the epoch, so the main stream stays
            # the same as with ell_tables off
            self._refresh_ell(epoch_ell_rng(epoch))
        pos = self.train_edges
        e = pos.shape[1]
        perm = rng.permutation(e)
        if cfg.neg_mode == "randint_target":
            # negatives keep the positive sources, uniform targets
            neg = np.stack([pos[0], rng.integers(0, self.ds.n_nodes, size=e)])
        elif self._graph_device.type == "cuda":
            neg = self._graph_negatives(e, rng)
        else:
            neg = B.negative_sampling(self.ds.edge_index, self.ds.n_nodes, e, rng)
        if cfg.increasealpha and state.sched:
            # the reference's ramp max(0, min((epoch - 5) * 0.1, 1))
            with torch.no_grad():
                state.sched["alpha2"].fill_(max(0.0, min((epoch - 5) * 0.1, 1.0)))
        bs = cfg.batch_size
        if e < bs and not getattr(self, "_warned_zero_batches", False):
            warnings.warn(
                f"batch_size {bs} > {e} train edges: the drop-tail train "
                f"iterator runs ZERO batches per epoch (reference "
                f"PermIterator semantics) - nothing will train.  Reduce "
                f"batch_size (<= {e}).", RuntimeWarning, stacklevel=2)
            self._warned_zero_batches = True
        self.gen.manual_seed(int(rng.integers(2**31)))
        losses = []
        for start in range(0, e - bs + 1, bs):
            idx = perm[start:start + bs]
            if cfg.sort_batch and self._split is None:
                # cluster the batch's gathers by source id; pos/neg share the
                # permutation so per-index loss pairing survives (the dual-K
                # degree sort supersedes it)
                idx = idx[np.argsort(pos[0, idx], kind="stable")]
            pe, ne, mp, inv_p, inv_n = self.prepare_batch(
                pos[:, idx], neg[:, idx], idx)
            state, loss = self.train_step(state, pe, ne, mp, self.gen, inv_p, inv_n)
            losses.append(loss)
        if not losses:
            return state, 0.0
        return state, float(np.mean(torch.stack(losses).double().cpu().numpy()))

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def encode(self, state: TrainState, full: bool = False) -> torch.Tensor:
        """Eval-mode hidden states over the train graph (or the train+valid
        graph with ``full``); node-sharded, the encoder runs on the shards
        and h is gathered whole."""
        state.encoder.eval()
        if self.sharded:
            return self._sharded_eval().encode(state, full)
        return state.encoder(self.x, self.full_g if full else self.g)

    def _sharded_eval(self):
        """The node-sharded encoder and scorers of this rank (built on first
        use; eval before any epoch builds epoch 1's ELL tables)."""
        if getattr(self, "_sg_eval", None) is None:
            from ocn_tpu_torch.parallel.sharded_graph import ShardedEval
            if self._use_ell and self.cfg.ell_eval and self._ell is None:
                self._refresh_ell(epoch_ell_rng(1))
            self._sg_eval = ShardedEval(self)
        return self._sg_eval

    @torch.no_grad()
    def _score_batches(self, state: TrainState, h, g: Graph, edges: np.ndarray,
                       adj2: Optional[Graph], k: Optional[int] = None,
                       fold0: int = 0) -> np.ndarray:
        """Score (n, 2) edges in fixed (2, testbs) batches at frame width
        ``k`` (None = pad_deg); the ragged tail is padded and value-masked
        so batch column sums see only real edges.  Capped rows off the ELL
        tables are sampled from a generator seeded by (seed, fold0, batch
        start), so eval is deterministic across calls; ``fold0`` gives each
        dual-K eval body its own stream."""
        state.predictor.eval()
        bs = self.cfg.testbs
        # built from the graph being scored (full_g for the test split
        # under use_valedges_as_input)
        y = h[g.col] if self._window_table() else None
        adj3 = self._eval_adj3()
        out = []
        n = edges.shape[0]
        for start in range(0, n, bs):
            chunk = np.asarray(edges[start:start + bs]).T  # (2, c)
            c = chunk.shape[1]
            if bs - c:
                chunk = np.concatenate(
                    [chunk, np.zeros((2, bs - c), chunk.dtype)], axis=1)
            valid = torch.zeros(bs, device=self.device)
            valid[:c] = 1.0
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cfg.seed * 0x9E3779B1 + fold0 * 0x85EBCA77
                            + start)
            s = self._score_chunk(
                state, h, g, torch.as_tensor(chunk, dtype=torch.int64,
                                             device=self.device),
                valid, gen, False, adj2, y=y, k=k, adj3=adj3)
            out.append(s[:c].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def _score_split(self, state: TrainState, h, g: Graph, edges: np.ndarray,
                     adj2: Optional[Graph]) -> np.ndarray:
        """Scores of one eval split.  With the dual-K split at eval the
        split is sorted by source degree once, full testbs batches of
        sources with degree <= k_small (in the graph being scored) run at
        width k_small, the rest at pad_deg, and the scores are put back in
        order.  The incomplete family's outer width caps both endpoints'
        windows, so it sorts by the larger of the two degrees."""
        cfg = self.cfg
        n = edges.shape[0]
        if self.sharded:
            return self._sharded_eval().scores(state, h, edges,
                                               full=g is self.full_g
                                               and g is not self.g)
        if not (cfg.dual_k_eval and 0 < cfg.k_small < cfg.pad_deg
                and n > cfg.testbs):
            return self._score_batches(state, h, g, edges, adj2)
        edges = np.asarray(edges)
        # degrees of the graph being scored: on full_g a source may cross
        # k_small once the valid edges are added, and must then go big
        gdeg = g.deg.cpu().numpy()
        deg = gdeg[edges[:, 0]]
        if not self.frame_based:
            deg = np.maximum(deg, gdeg[edges[:, 1]])
        sp = np.argsort(deg, kind="stable")
        split_at = (int(np.sum(deg <= cfg.k_small)) // cfg.testbs) * cfg.testbs
        se = edges[sp]
        out = np.concatenate([
            self._score_batches(state, h, g, se[:split_at], adj2,
                                k=cfg.k_small, fold0=1),
            self._score_batches(state, h, g, se[split_at:], adj2, fold0=2),
        ])
        inv = np.empty(n, np.int64)
        inv[sp] = np.arange(n)
        return out[inv]

    def _eval_graphs(self) -> Tuple[Graph, Graph]:
        """(g, adj2) for eval scoring, with the current ELL tables attached
        when ``ell_eval`` (rows with degree <= pad_deg score the same;
        capped rows use the frozen window)."""
        if (self.cfg.ell_eval and self._use_ell and self._ell is not None
                and not self.sharded):  # the sharded tables are shards
            a2 = self.adj2
            if "tbl2" in self._ell:
                a2 = a2.with_ell(self._ell["tbl2"], self._ell["off2"])
            return self.g.with_ell(self._ell["tbl1"], self._ell["off1"]), a2
        return self.g, self.adj2

    def _eval_adj3(self) -> Optional[Graph]:
        """cn6's A^3 for eval: the train graph's, on every split (the
        train+valid graph has none), with its ELL table when ``ell_eval``."""
        if (self.adj3 is not None and self.cfg.ell_eval and self._use_ell
                and self._ell is not None and not self.sharded):
            return self.adj3.with_ell(self._ell["tbl3"], self._ell["off3"])
        return self.adj3

    def evaluate(self, state: TrainState) -> Dict[str, Tuple[float, float, float]]:
        """Score train / valid / test positives against the valid / test
        negatives; Hits@K for K in {20, 50, 100} as (train, valid, test).
        ``use_valedges_as_input`` re-encodes with the train+valid graph for
        the test split, which has no ELL table."""
        se = self.ds.split_edge
        h = self.encode(state)
        g, a2 = self._eval_graphs()
        pos_train = self._score_split(state, h, g, se["train"]["edge"], a2)
        pos_valid = self._score_split(state, h, g, se["valid"]["edge"], a2)
        neg_valid = self._score_split(state, h, g, se["valid"]["edge_neg"], a2)
        if self.cfg.use_valedges_as_input:
            h = self.encode(state, full=True)
            g, a2 = self.full_g, self.full_adj2
        pos_test = self._score_split(state, h, g, se["test"]["edge"], a2)
        neg_test = self._score_split(state, h, g, se["test"]["edge_neg"], a2)
        return {
            f"Hits@{k}": (
                M.hits_at_k(pos_train, neg_valid, k),
                M.hits_at_k(pos_valid, neg_valid, k),
                M.hits_at_k(pos_test, neg_test, k),
            )
            for k in (20, 50, 100)
        }

    def evaluate_mrr(self, state: TrainState) -> Dict[str, float]:
        """citation2's MRR: each valid and test source scored against its
        target and against its row of ``target_node_neg``, on the train
        graph; {"valid": mrr, "test": mrr}."""
        se = self.ds.split_edge
        h = self.encode(state)
        g, a2 = self._eval_graphs()
        out = {}
        for part in ("valid", "test"):
            src = se[part]["source_node"]
            negs = se[part]["target_node_neg"]  # (n, num_neg)
            pos = self._score_split(
                state, h, g, np.stack([src, se[part]["target_node"]], 1), a2)
            n, m = negs.shape
            flat = np.stack([np.repeat(src, m), negs.reshape(-1)], 1)
            neg = self._score_split(state, h, g, flat, a2).reshape(n, m)
            out[part] = M.mrr(pos, neg)
        return out

"""Training/eval engine (port of ocn_tpu/train/loop.py for the frame-based
predictors cn1 and cn5-cn9, under either encoder stack).

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

``dtype="bfloat16"`` keeps the node features and the valid/correction
planes in bfloat16; the first Dense promotes to float32 (nn/mlp.py), so
h, the frames and every parameter are float32, as in the JAX package.

Randomness (dropout, DropAdj, window offsets of capped rows off the tables)
comes from one ``torch.Generator`` per epoch, seeded from the host NumPy
generator that also draws the batch permutation and negatives, exactly as
ocn_tpu draws its PRNG key; the ELL offsets come from a NumPy generator
derived from the epoch number.  ``evaluate`` gives Hits@K, ``evaluate_mrr``
the citation2 MRR.  Not ported yet: the incomplete family (cn2/cn3/cn4),
meshes (Config.require_supported).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ocn_tpu_torch.config import Config, require_supported
from ocn_tpu_torch.data.loaders import LinkDataset
from ocn_tpu_torch.nn.encoder import GCNEncoder
from ocn_tpu_torch.nn.predictors import THREE_HOP, build_predictor
from ocn_tpu_torch.ops.frame import CNFrame, cn3_frame, cn_frames
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse import ell as ELL
from ocn_tpu_torch.sparse.csr import Graph, graph_from_numpy
from ocn_tpu_torch.train import losses as L
from ocn_tpu_torch.train import metrics as M


def resolve_device(device) -> torch.device:
    """The torch device for an entry point; a CUDA request without a card
    raises instead of dropping to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ocn_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


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


class Trainer:
    """Drives one (dataset, config) pair on one device."""

    def __init__(self, cfg: Config, ds: LinkDataset, device="cuda"):
        require_supported(cfg)
        self.cfg = cfg
        self.ds = ds
        self.device = resolve_device(device)
        g_host = ds.as_graph()
        self.g = g_host.to(self.device)
        full_host = ds.full_graph() if ds.full_edge_index is not None else None
        self.full_g = full_host.to(self.device) if full_host is not None else self.g
        # "bfloat16" stores the node features and the valid/correction
        # planes in bfloat16; parameters, h and the frames stay float32
        # (nn/mlp.py Dense), as in the JAX package
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        if ds.max_x >= 0:
            self.x = torch.as_tensor(ds.x, dtype=torch.int64, device=self.device)
        else:
            self.x = torch.as_tensor(ds.x, dtype=self.dtype, device=self.device)

        # precomputed A^2 for the "gather" two-hop mode: one host SpGEMM per
        # graph instead of the reference's per-batch SpGEMM
        self.adj2 = self.full_adj2 = None
        self.adj2_seconds = 0.0
        if cfg.two_hop_mode == "gather":
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
        self._use_ell = bool(cfg.ell_tables and self.g.packed is not None
                             and self.adj2 is not None
                             and self.adj2.packed is not None)

    def _build_adj2(self, g: Graph, keep_host: bool = False) -> Graph:
        ip = g.indptr.numpy()
        col = g.col.numpy()[: int(ip[-1])]
        ip2, col2, val2 = B.adj2_csr(ip, col, g.n_nodes, cap=self.cfg.adj2_cap)
        if keep_host:  # the host CSR feeds cn6's A^3 SpGEMM
            self._adj2_host = (ip2, col2, val2)
        # consumed only through window gathers: upload indptr/deg and the
        # packed entries (4 bytes each), or col/val where counts do not pack
        return graph_from_numpy(ip2, col2, g.n_nodes, val2,
                                gather_only=True).to(self.device)

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
        return graph_from_numpy(ip3, col3, g.n_nodes, val3,
                                gather_only=True).to(self.device)

    def _k3_width(self) -> int:
        """Width of cn6's A^3 row gather and of its ELL table: Config.k3, or
        min(pad_deg2, 16)."""
        if self.cfg.k3 > 0:
            return self.cfg.k3
        return min(self.cfg.pad_deg2, 16)

    def _refresh_ell(self, rng: np.random.Generator) -> None:
        """Re-draw the frozen window offsets on the host and rebuild the
        ELL tables (g at pad_deg, A^2 at pad_deg2, cn6's A^3 at k3, whose
        offsets are drawn last) on the device."""
        cfg = self.cfg
        off1 = ELL.draw_offsets(self._deg_np, cfg.pad_deg, rng)
        off2 = ELL.draw_offsets(self.adj2.deg.cpu().numpy(), cfg.pad_deg2, rng)
        o1 = torch.as_tensor(off1, device=self.device)
        o2 = torch.as_tensor(off2, device=self.device)
        self._ell = dict(
            tbl1=ELL.build_ell(self.g.packed, self.g.indptr, o1, cfg.pad_deg),
            off1=o1, off1_np=off1,
            tbl2=ELL.build_ell(self.adj2.packed, self.adj2.indptr, o2,
                               cfg.pad_deg2),
            off2=o2)
        if self.adj3 is not None:
            k3 = self._k3_width()
            o3 = torch.as_tensor(
                ELL.draw_offsets(self.adj3.deg.cpu().numpy(), k3, rng),
                device=self.device)
            self._ell.update(
                tbl3=ELL.build_ell(self.adj3.packed, self.adj3.indptr, o3, k3),
                off3=o3)

    def _split_plan(self) -> Optional[Tuple[int, int]]:
        """Chunk counts (n_small_pos, n_small_neg) of the dual-K split, or
        None when it is off.  Sorting each batch by source degree puts the
        low-degree majority in the leading chunks, so a fixed boundary at
        the degree distribution's quantile routes almost exactly the
        deg <= k_small edges to the small body; edges that spill into it get
        the usual deg/k reweighted cap.  With frame_group > 1 the small
        body's chunk count nsp + nsn is rounded down to whole groups (taking
        from the larger side, negatives on a tie), which moves chunks to the
        big body and caps no extra edge."""
        cfg = self.cfg
        if cfg.k_small <= 0 or cfg.k_small >= cfg.pad_deg or cfg.hoist_frames:
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
        opt = torch.optim.Adam([
            {"params": list(encoder.parameters()), "lr": cfg.gnnlr},
            {"params": list(predictor.parameters()), "lr": cfg.prelr},
        ], betas=(0.9, 0.999), eps=1e-8)
        return TrainState(encoder, predictor, opt)

    # ------------------------------------------------------- chunked scoring
    def _chunk(self) -> int:
        cfg = self.cfg
        target = cfg.linkbatchsize if cfg.linkbatchsize > 0 else 4096
        return _largest_divisor_leq(cfg.batch_size, target)

    def _score_chunk(self, state: TrainState, h, g: Graph, edges, valid, gen,
                     training: bool, adj2: Optional[Graph], corr=None, y=None,
                     k: Optional[int] = None, grp: int = 1,
                     adj3: Optional[Graph] = None) -> torch.Tensor:
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
        the streams cannot equal JAX's fold_in keys."""
        cfg = self.cfg
        frame_gen = gen if (training or cfg.eval_sampling) else None
        cn1, cn2, src = cn_frames(
            g, edges, k=k or cfg.pad_deg, k2=cfg.pad_deg2, gen=frame_gen,
            adj2=adj2, self_corr=corr, k2_dst=cfg.pad_deg2_dst,
            cn2_counts=cfg.cn2_counts, exact_two_hop=cfg.exact_two_hop,
            with_src=True)
        vals = [cn1.val, cn2.val]
        if cfg.predictor in THREE_HOP:
            # cn3 shares the candidate frame src of cn1 and cn2
            k3 = self._k3_width()
            vals.append(cn3_frame(g, edges, src, k2=k3, k3=k3,
                                  counts=cfg.cn2_counts, adj3=adj3).val)
        # padded/invalid edges must not pollute batch column sums / EMA
        vals = [v * valid[:, None] for v in vals]
        c = edges.shape[1] // grp
        outs = []
        for j in range(grp):
            sl = slice(j * c, (j + 1) * c)
            frames = [CNFrame(cn1.ids[sl], v[sl], g.n_nodes) for v in vals]
            out = state.predictor(
                h, g.n_nodes, *frames, edges[:, sl],
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
        if isinstance(mask_positions, dict):
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
        them all (cn6 is never grouped).  Steps the predictor's EMA
        buffers."""
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
        # the window table: one CSR-order row gather per step; the gradient
        # to h flows through the frame matmuls' backward, not through y
        y = h.detach()[g.col] if cfg.window_table else None

        def score(edges, n_pos, k=None):
            # (2, n*c) edges, the first n_pos chunks positive, scored in
            # groups of _group_size(n, frame_group) chunks, or hoisted: one
            # group of all n
            n = edges.shape[1] // c
            if cfg.predictor in THREE_HOP:
                grp = 1
            elif cfg.hoist_frames:
                grp = max(n, 1)
            else:
                grp = _group_size(n, cfg.frame_group)
            valid = torch.ones(grp * c, dtype=self.dtype, device=self.device)
            out = []
            for i in range(0, n, grp):
                # positive chunks lead the body, so a group's are a prefix
                npos = min(max(n_pos - i, 0), grp)
                corr = None
                if cfg.maskinput and npos:
                    corr = valid if npos == grp else torch.cat(
                        [valid[:npos * c], torch.zeros_like(valid[npos * c:])])
                out.append(self._score_chunk(
                    state, h, g, edges[:, i * c:(i + grp) * c], valid, gen,
                    True, adj2, corr=corr, y=y, k=k, grp=grp, adj3=adj3))
            return torch.cat(out) if out else h.new_zeros(0)

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

    def train_step(self, state: TrainState, pos: torch.Tensor, neg: torch.Tensor,
                   mask_positions, gen: torch.Generator,
                   inv_p: Optional[torch.Tensor] = None,
                   inv_n: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step on the inputs of ``prepare_batch`` (positive
        and negative (2, batch_size) edges, mask positions, and with the
        dual-K split the inverse permutations); returns (state, detached
        loss)."""
        loss = self.step_loss(state, pos, neg, mask_positions, gen, inv_p, inv_n)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        return state, loss.detach()

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
        (None where they do not apply)."""
        dev = self.device
        inv_p = inv_n = None
        if self._split is not None:
            ar = np.arange(pos_b.shape[1])
            sp = np.argsort(self._deg_np[pos_b[0]], kind="stable")
            sn = np.argsort(self._deg_np[neg_b[0]], kind="stable")
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
        if self._ell is not None:
            ell = self._ell
            aux = {"csr": mp, "ell1": ell["tbl1"], "off1": ell["off1"],
                   "ell2": ell["tbl2"], "off2": ell["off2"]}
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

    def train_epoch(self, state: TrainState, rng: np.random.Generator,
                    epoch: int) -> Tuple[TrainState, float]:
        """One pass over the train edges in shuffled full batches (the ragged
        tail is dropped, as the reference's PermIterator does); returns the
        mean batch loss."""
        cfg = self.cfg
        if self._use_ell and (
                self._ell is None or (epoch - 1) % max(cfg.ell_refresh, 1) == 0):
            # a generator derived from the epoch, so the main stream stays
            # the same as with ell_tables off
            self._refresh_ell(np.random.default_rng(
                (epoch * 0x9E3779B1 + 0x85EBCA77) & 0xFFFFFFFF))
        pos = self.train_edges
        e = pos.shape[1]
        perm = rng.permutation(e)
        if cfg.neg_mode == "randint_target":
            # negatives keep the positive sources, uniform targets
            neg = np.stack([pos[0], rng.integers(0, self.ds.n_nodes, size=e)])
        else:
            neg = B.negative_sampling(self.ds.edge_index, self.ds.n_nodes, e, rng)
        bs = cfg.batch_size
        if e < bs and not getattr(self, "_warned_zero_batches", False):
            warnings.warn(
                f"batch_size {bs} > {e} train edges: the drop-tail train "
                f"iterator runs ZERO batches per epoch (reference "
                f"PermIterator semantics) - nothing will train.  Reduce "
                f"batch_size (<= {e}).", RuntimeWarning, stacklevel=2)
            self._warned_zero_batches = True
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(2**31)))
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
            state, loss = self.train_step(state, pe, ne, mp, gen, inv_p, inv_n)
            losses.append(loss.item())
        return state, float(np.mean(losses)) if losses else 0.0

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def encode(self, state: TrainState, full: bool = False) -> torch.Tensor:
        """Eval-mode hidden states over the train graph (or the train+valid
        graph with ``full``)."""
        state.encoder.eval()
        return state.encoder(self.x, self.full_g if full else self.g)

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
        y = h[g.col] if self.cfg.window_table else None
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
        order."""
        cfg = self.cfg
        n = edges.shape[0]
        if not (cfg.dual_k_eval and 0 < cfg.k_small < cfg.pad_deg
                and n > cfg.testbs):
            return self._score_batches(state, h, g, edges, adj2)
        edges = np.asarray(edges)
        # degrees of the graph being scored: on full_g a source may cross
        # k_small once the valid edges are added, and must then go big
        deg = g.deg.cpu().numpy()[edges[:, 0]]
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
        if self.cfg.ell_eval and self._use_ell and self._ell is not None:
            return (self.g.with_ell(self._ell["tbl1"], self._ell["off1"]),
                    self.adj2.with_ell(self._ell["tbl2"], self._ell["off2"]))
        return self.g, self.adj2

    def _eval_adj3(self) -> Optional[Graph]:
        """cn6's A^3 for eval: the train graph's, on every split (the
        train+valid graph has none), with its ELL table when ``ell_eval``."""
        if (self.adj3 is not None and self.cfg.ell_eval and self._use_ell
                and self._ell is not None):
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

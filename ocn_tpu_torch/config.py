"""Single dataclass config replacing the reference's ~45 argparse flags
duplicated across five drivers (reference NeighborOverlap_large.py:183-250 is
the canonical list; SURVEY.md §2.6).  Field names keep the flag names so the
README commands translate 1:1; `presets()` encodes the per-dataset README
commands (README.md:24-98).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # data
    dataset: str = "collab"
    use_valedges_as_input: bool = False
    load: Optional[str] = None
    # schedule
    epochs: int = 40
    runs: int = 3
    batch_size: int = 8192
    testbs: int = 8192
    linkbatchsize: int = -1          # <=0: auto (micro-batch inside the jitted step)
    maskinput: bool = False
    # encoder
    model: str = "gcn"
    mplayers: int = 1
    hiddim: int = 32
    ln: bool = False
    res: bool = False
    jk: bool = False
    gnndp: float = 0.3
    gnnedp: float = 0.3
    xdp: float = 0.3
    tdp: float = 0.3
    gnnlr: float = 3e-4
    encoder_stack: str = "ts"        # "ts" (GCN) | "ho" (GCN2/GCN3 pygho stack)
    # predictor
    predictor: str = "cn5"
    nnlayers: int = 3
    lnnn: bool = False
    predp: float = 0.3
    preedp: float = 0.3
    prelr: float = 3e-4
    beta: float = 1.0
    alpha: float = 1.0
    use_xlin: bool = False
    tailact: bool = False
    twolayerlin: bool = False
    increasealpha: bool = False
    splitsize: int = -1              # parity flag; XLA scan chunking supersedes it
    # incomplete-CN family
    probscale: float = 5.0
    proboffset: float = 3.0
    pt: float = 0.5
    learnpt: bool = False
    trndeg: int = -1
    tstdeg: int = -1
    cndeg: int = -1
    depth: int = 1
    cnprob: float = 0.0
    recursion_train_mode: bool = True  # cn2/cn3/cn4: score the stop-gradient
                                     # recursion with dropouts ACTIVE in train
                                     # mode, like the reference's torch.no_grad
                                     # under module.train() (model.py:926-946);
                                     # False = eval-mode (deterministic)
                                     # recursive scoring
    # higher-order
    adj2byblock: bool = False        # parity flag; candidate-frame SDDMM replaces it
    sum: float = 1.0                 # cn7/cn8 empty-column fill (`--sum`)
    polyfirst: int = 0
    polysecond: int = 0
    # artifacts
    save_gemb: bool = False
    savex: bool = False
    loadx: bool = False
    savemod: bool = False
    loadmod: bool = False
    checkpoint_dir: Optional[str] = None
    # PLNLP
    losstrick: str = "simple"
    lossmargin: float = 0.0
    lossweight: float = 1.0
    # TPU-native knobs (no reference counterpart)
    pad_deg: int = 64                # candidate-frame width K (neighbor cap)
    pad_deg2: int = 64               # cap for dst/candidate neighbor lists (K2)
    pad_deg2_dst: int = 0            # separate cap for the dst frame N(j) in
                                     # "gather" two-hop mode (only the cn1
                                     # membership reads it there; 96% of
                                     # collab edge destinations have degree
                                     # <= 16 while A^2 rows are fat, so a
                                     # smaller dst cap removes mostly-padding
                                     # gathers/compares).  0 = use pad_deg2.
    count2_chunk: int = 4096         # edge chunk for on-the-fly A^2 counts
    two_hop_mode: str = "gather"     # "gather": precomputed row-capped A^2;
                                     # "sddmm": on-the-fly exact counts
    hoist_frames: bool = False       # build CN frames for the whole batch
                                     # outside the link scan (faster steps,
                                     # much slower XLA compile at batch 65536)
    frame_group: int = 1             # link chunks whose frames are built in
                                     # one vectorized shot per scan step
                                     # (predictor + column norms stay
                                     # per-chunk); bounded-compile middle
                                     # ground between per-chunk and hoisted
    adj2_cap: int = 1024             # A^2 row cap for the host SpGEMM
    adj3_cap: int = 256              # A^3 row cap (cn6 "gather" fast path)
    k3: int = 0                      # cn6 A^3 row-gather width (cn3_frame's
                                     # dst window + the tbl3 ELL width).
                                     # 0 = auto: min(pad_deg2, 16).  Wider
                                     # reads more of each capped A^3 row per
                                     # chunk (cost scales with B*k3 on the
                                     # non-ELL path, N*k3 table memory on the
                                     # ELL path); sensitivity study in
                                     # BASELINE.md round 5.
    window_table: bool = False       # hoist y = h.detach()[g.col] once per
                                     # step and read frame rows as
                                     # contiguous CSR windows of it through
                                     # the window-gather kernel
                                     # (ops/window_gather.py).  Off by
                                     # default, as in ocn_tpu, where a TPU
                                     # v5e A/B measured it slower end to
                                     # end; its H100 numbers are in PERF.md.
    cn2_counts: bool = False         # True => pygho-stack path-count values
    neg_mode: str = "uniform"        # "uniform": PyG negative_sampling non-
                                     # edges; "randint_target": keep sources,
                                     # uniform targets (citation2 driver,
                                     # NeighborOverlapCitation2.py:181-182)
    exact_two_hop: bool = False      # SPD.py exactly-distance-2 semantics
    reorder: str = "bfs"             # node relabeling for gather locality:
                                     # "bfs" (+9% measured on chip) | "none";
                                     # metrics are relabel-invariant
    k_small: int = 0                 # dual-K occupancy split: when > 0, each
                                     # training batch is sorted by source
                                     # degree (host-side, pairing restored by
                                     # inverse permutation before the loss)
                                     # and the link scan runs as TWO bodies —
                                     # low-degree chunks at frame width
                                     # k_small, the tail at pad_deg.  At K=64
                                     # the collab pos-src frames are only 29%
                                     # occupied and negative frames 8.6%
                                     # (BENCH_NOTES.md), so most frame math is
                                     # padding; k_small=16 fits 66% of pos
                                     # sources / 97% of neg sources exactly.
                                     # Edges that spill a small chunk get the
                                     # framework's standard deg/k reweighted
                                     # cap (unbiased; reference concedes caps
                                     # via cndeg, utils.py:109-143). 0 = off.
    small_frac: float = -1.0         # fraction of positive chunks in the
                                     # small body; < 0 = auto from the train-
                                     # edge source-degree distribution
    small_frac_neg: float = -1.0     # same for negative chunks; < 0 = auto
                                     # from the node-degree distribution
    ell_tables: bool = True          # ELL window-table gathers (sparse/
                                     # ell.py): per-node neighbor windows
                                     # frozen per refresh in (N, K) row-
                                     # gatherable tables — TPU gathers are
                                     # descriptor-rate-bound, so row gathers
                                     # are ~6x cheaper than the flat window
                                     # gathers they replace (BENCH_NOTES.md
                                     # round 2).  Train path only; requires
                                     # the packed col|val layout + gather
                                     # two-hop mode.
    ell_refresh: int = 1             # rebuild the ELL window sample every
                                     # this many epochs (re-draws the capped
                                     # rows' window offsets)
    ell_eval: bool = True            # score eval splits through the same ELL
                                     # tables (uncapped rows bit-identical;
                                     # capped rows use the frozen window —
                                     # measured +42% eval throughput)
    lane_dropadj: bool = True        # incomplete-CN family (cn2/cn3/cn4):
                                     # apply preedp/DropAdj as Bernoulli LANE
                                     # masks on the gathered windows instead
                                     # of mutating adjacency values — value
                                     # mutation detaches the packed/ELL
                                     # gather layout every preedp>0 chunk
                                     # and costs the family its ~5.7x fast
                                     # path (BENCH_NOTES r3).  Same marginal
                                     # estimator (unbiased in the values);
                                     # correlation-only deviation, PARITY.md.
                                     # False = reference value-mutation path.
    rec_k: int = 0                   # incomplete-CN family (cn2/cn3/cn4):
                                     # -1 = AUTO (smallest power of two
                                     # covering the 75th percentile of
                                     # edge-endpoint degrees, clamped to
                                     # [8, pad_deg] — picks the
                                     # A/B-validated 16 on collab-class
                                     # graphs, full width on dense ones).
                                     # frame width for the RECURSIVE scorer
                                     # (the depth-1 stop-gradient re-scoring
                                     # of B*resdeg potential edges — the
                                     # dominant cost of the family).  A
                                     # narrower width caps the recursion's
                                     # adjacency sample with the standard
                                     # deg/k reweighting — the same estimator
                                     # family as the reference's trndeg/
                                     # tstdeg/cndeg caps (utils.py:109-143).
                                     # 0 = full pad_deg width (exact
                                     # reference semantics).
    dual_k_eval: bool = True         # score eval splits with the dual-K
                                     # split too (k_small > 0): each split is
                                     # degree-sorted once, full testbs batches
                                     # of deg<=k_small sources score at frame
                                     # width k_small (no extra capping — only
                                     # exact-fit edges go small; the boundary
                                     # remainder rides the big body), scores
                                     # inverse-permuted back.  Pairing-free
                                     # at eval (scores only).  Batch
                                     # composition changes like any batch
                                     # permutation (PARITY.md §6).
    eval_sampling: bool = True       # sample degree-capped rows randomly at
                                     # eval time too (the reference's
                                     # sparsesample_reweight is random in
                                     # train AND eval, utils.py:109-143); the
                                     # key is a fixed fold of the chunk
                                     # offset, so eval stays deterministic
                                     # across calls.  False = deterministic
                                     # first-k window (biased when rows
                                     # exceed pad_deg; only exact when
                                     # pad_deg >= max degree).
    sort_batch: bool = False         # sort each training batch by source id
                                     # (pairing-preserving); measured neutral
                                     # on chip (87.1k vs 87.2k edges/s) - the
                                     # K=64 windows already give intra-row
                                     # contiguity - so off by default
    dtype: str = "float32"           # "bfloat16" for MXU-friendly training
    platform: str = ""               # "" = default backend; "cpu" forces CPU
    profile_dir: str = ""            # write a jax.profiler trace of epoch 1
                                     # here (open with xprof/tensorboard)
    seed: int = 0
    data_root: str = "dataset"
    synthetic_scale: float = 1.0
    dp_devices: int = 1              # data-parallel mesh size (edge-batch DP)
    graph_sharding: str = "replicated"  # "node": shard adjacency, A^2 and
                                     # features over the dp axis with halo-
                                     # exchange SpMM + owner-gather CN frames
                                     # (parallel/sharded_graph.py); >HBM
                                     # graphs.  "replicated": GSPMD mesh path
    tp_devices: int = 1              # tensor-parallel mesh size (hidden shard)

    def predictor_kwargs(self) -> dict:
        return dict(
            dropout=self.predp, edrop=self.preedp, ln=self.lnnn,
            cndeg=self.cndeg, use_xlin=self.use_xlin, tailact=self.tailact,
            twolayerlin=self.twolayerlin, beta=self.beta, alpha=self.alpha,
            probscale=self.probscale, proboffset=self.proboffset, pt=self.pt,
            learnpt=self.learnpt, trndeg=self.trndeg, tstdeg=self.tstdeg,
            depth=self.depth, sum=self.sum, polyfirst=self.polyfirst,
            polysecond=self.polysecond, k=self.pad_deg, rec_k=self.rec_k,
            recursion_train_mode=self.recursion_train_mode,
            lane_dropadj=self.lane_dropadj,
        )


# ---------------------------------------------------------------------------
# README-faithful presets (VERDICT round-3 item 1).
#
# `_README_PRESETS[(dataset, predictor)]` is a field-for-field translation of
# the reference command at the cited README.md line.  A dict lists EXACTLY the
# flags the command pins; every field not listed takes the `Config` default,
# and `Config` defaults mirror the reference argparse defaults
# (NeighborOverlap_large.py:183-250; the ppa/citation2 drivers differ only on
# `--sum` default 0 and `--linkbatchsize` default 8192, both pinned explicitly
# by their commands).  Pinned by tests/test_presets.py against frozen dicts.
#
# `_DRIVER_OVERLAYS` encodes WHICH reference driver the command invokes —
# still fidelity, not tuning: the ppa/citation2/SPD commands run the pygho
# stack (GCN2/GCN3 encoders, path-count cn2 values, randint-target negatives,
# SPD's exactly-distance-2 mask), which the README command line itself cannot
# express because the reference splits them across script files.
#
# `_TPU_OVERLAYS` holds the TPU-native performance/memory knobs (dual-K
# split, A^2 row caps) — fields with NO reference counterpart, separable via
# ``presets(..., tpu_overlay=False)``.  They never touch reference flags.
# ---------------------------------------------------------------------------

# README.md:27 — Cora OCN (no --res; --sum 0 changes cn7's empty-column fill
# and is carried by cn5 for flag fidelity even though cn5 ignores it)
_CORA_CMD = dict(
    xdp=0.7, tdp=0.3, pt=0.75, gnnedp=0.0, preedp=0.4, predp=0.05,
    gnndp=0.05, probscale=4.3, proboffset=2.8, alpha=1.0, gnnlr=0.0043,
    prelr=0.0024, batch_size=1152, ln=True, lnnn=True, epochs=100, runs=10,
    model="puregcn", hiddim=256, mplayers=1, testbs=8192, maskinput=True,
    jk=True, use_xlin=True, tailact=True, sum=0.0,
)
# README.md:31 / :71 — Citeseer OCN and OCNP share one command verbatim
_CITESEER_CMD = dict(
    epochs=100, runs=10, batch_size=384, testbs=4096, use_xlin=True,
    maskinput=True, lnnn=True, res=True, jk=True, model="puremean",
    mplayers=3, nnlayers=1, hiddim=64, gnndp=0.12, xdp=0.73, tdp=0.88,
    gnnedp=0.07, predp=0.19, preedp=0.66, gnnlr=0.0009, prelr=0.00096,
    beta=4.36, alpha=2.48, probscale=6.19, proboffset=9.69, pt=0.042,
    cnprob=0.94, sum=27.29,
)
# README.md:37 / :76 — Pubmed OCN and OCNP share one command verbatim
_PUBMED_CMD = dict(
    xdp=0.3, tdp=0.0, pt=0.5, gnnedp=0.0, preedp=0.0, predp=0.05, gnndp=0.1,
    probscale=5.3, proboffset=0.5, alpha=0.3, gnnlr=0.0097, prelr=0.002,
    batch_size=2048, ln=True, lnnn=True, epochs=200, runs=10, model="puregcn",
    hiddim=256, mplayers=1, testbs=8192, maskinput=True, jk=True,
    use_xlin=True, tailact=True, sum=1.0,
)
# README.md:42 — collab OCN (gin encoder, 1 layer, no --res)
_COLLAB_OCN_CMD = dict(
    use_valedges_as_input=True, epochs=200, runs=10, batch_size=65536,
    testbs=65536, maskinput=True, mplayers=1, nnlayers=3, hiddim=256,
    ln=True, lnnn=True, jk=True, gnndp=0.05, xdp=0.7, tdp=0.3, gnnedp=0.0,
    predp=0.05, preedp=0.4, gnnlr=0.0043, prelr=0.0024, beta=1.0, alpha=1.0,
    use_xlin=True, tailact=True, probscale=4.3, proboffset=2.8, pt=0.75,
    depth=1, model="gin",
)
# README.md:81 — collab OCNP (different dropouts/lrs; --res, no --jk)
_COLLAB_OCNP_CMD = dict(
    xdp=0.25, tdp=0.05, pt=0.1, gnnedp=0.25, preedp=0.0, predp=0.3,
    gnndp=0.1, probscale=2.5, proboffset=6.0, alpha=1.05, gnnlr=0.0082,
    prelr=0.0037, batch_size=65536, ln=True, lnnn=True, epochs=100, runs=10,
    model="gin", hiddim=256, mplayers=1, testbs=131072, maskinput=True,
    use_valedges_as_input=True, res=True, use_xlin=True, tailact=True,
)
# README.md:47 / :86 — ppa OCN and OCNP share one command verbatim
# (NeighborOverlap_large_ppa.py driver: all dropouts 0, --ln --lnnn --jk)
_PPA_CMD = dict(
    sum=0.0, epochs=20, runs=10, batch_size=16384, linkbatchsize=2048,
    testbs=2048, maskinput=True, mplayers=1, nnlayers=3, hiddim=64, ln=True,
    lnnn=True, jk=True, gnndp=0.0, xdp=0.0, tdp=0.0, gnnedp=0.0, predp=0.0,
    preedp=0.0, gnnlr=0.0013, prelr=0.0013, beta=1.0, alpha=1.0,
    use_xlin=True, tailact=True, probscale=4.3, proboffset=2.8, pt=0.75,
    depth=1, model="gcn", cnprob=0.0,
)
# README.md:53 / :92 — citation2 OCN and OCNP share one command verbatim
# (NeighborOverlapCitation2.py driver: --ln --res --jk, no lnnn/maskinput)
_CITATION2_CMD = dict(
    epochs=20, runs=10, batch_size=16384, testbs=2048, linkbatchsize=2048,
    use_xlin=True, ln=True, res=True, jk=True, tailact=True, model="gcn",
    mplayers=5, nnlayers=3, hiddim=32, depth=3, gnndp=0.28, xdp=0.5,
    tdp=0.28, gnnedp=0.20, predp=0.10, preedp=0.12, gnnlr=0.00023,
    prelr=0.0008, beta=0.23, alpha=1.33, probscale=2.64, proboffset=4.5,
    pt=0.34, cnprob=0.78, sum=1.0,
)
# README.md:59 / :98 — ddi OCN and OCNP share one command verbatim.  The
# README's `--alpha 7.18--probscale 4.31` typo (which argparse would reject)
# is resolved as alpha=7.18, probscale=4.31 — SURVEY.md §5 known defects.
_DDI_CMD = dict(
    epochs=100, runs=10, batch_size=32768, testbs=32768, use_xlin=True,
    adj2byblock=True, maskinput=True, lnnn=True, res=True, learnpt=True,
    model="puregcn", mplayers=3, nnlayers=3, hiddim=64, gnndp=0.25, xdp=0.13,
    tdp=0.38, gnnedp=0.51, predp=0.10, preedp=0.13, gnnlr=0.0009,
    prelr=0.00083, beta=0.33, alpha=7.18, probscale=4.31, proboffset=4.11,
    pt=0.73, cnprob=0.93, sum=2.74,
)

_README_PRESETS = {
    ("Cora", "cn5"): dict(_CORA_CMD),
    # README.md:66 — Cora OCNP: same flags, batch 1024 and 200 epochs
    ("Cora", "cn7"): {**_CORA_CMD, "batch_size": 1024, "epochs": 200},
    ("Citeseer", "cn5"): dict(_CITESEER_CMD),
    ("Citeseer", "cn7"): dict(_CITESEER_CMD),
    ("Pubmed", "cn5"): dict(_PUBMED_CMD),
    ("Pubmed", "cn7"): dict(_PUBMED_CMD),
    ("collab", "cn5"): dict(_COLLAB_OCN_CMD),
    ("collab", "cn7"): dict(_COLLAB_OCNP_CMD),
    ("ppa", "cn5"): dict(_PPA_CMD),
    ("ppa", "cn7"): dict(_PPA_CMD),
    ("citation2", "cn5"): dict(_CITATION2_CMD),
    ("citation2", "cn7"): dict(_CITATION2_CMD),
    ("ddi", "cn5"): dict(_DDI_CMD),
    ("ddi", "cn7"): dict(_DDI_CMD),
    # driver aliases (no README command of their own):
    # SPD.py = the citation2 command with exactly-distance-2 cn2 (SPD.py:65-95)
    ("citation2", "spd"): {**_CITATION2_CMD, "predictor": "cn5"},
    # PLNLP.py = the collab command with a ranking loss (PLNLP.py:155-191)
    ("collab", "plnlp"): {**_COLLAB_OCN_CMD, "predictor": "cn5",
                          "losstrick": "auc_loss"},
}

# which reference DRIVER executes the command (stack fidelity, not tuning)
_PYGHO_STACK = dict(encoder_stack="ho", cn2_counts=True)
_DRIVER_OVERLAYS = {
    ("ppa", "cn5"): dict(_PYGHO_STACK),                       # ppa driver
    ("ppa", "cn7"): dict(_PYGHO_STACK),
    ("citation2", "cn5"): {**_PYGHO_STACK, "neg_mode": "randint_target"},
    ("citation2", "cn7"): {**_PYGHO_STACK, "neg_mode": "randint_target"},
    ("citation2", "spd"): {**_PYGHO_STACK, "neg_mode": "randint_target",
                           "exact_two_hop": True},
}

# TPU-native knobs (no reference counterpart; presets(..., tpu_overlay=False)
# strips them).  Only fields from _TPU_OVERLAY_FIELDS may appear here — the
# preset test enforces that no reference flag hides in an overlay.
_TPU_OVERLAY_FIELDS = frozenset({
    "pad_deg", "pad_deg2", "pad_deg2_dst", "count2_chunk", "two_hop_mode",
    "hoist_frames", "frame_group", "adj2_cap", "adj3_cap", "k3",
    "window_table",
    "reorder", "k_small", "small_frac", "small_frac_neg",
    "ell_tables", "ell_refresh", "ell_eval", "rec_k", "lane_dropadj",
    "dual_k_eval",
    "eval_sampling", "sort_batch", "dtype", "graph_sharding", "dp_devices",
    "tp_devices",
})
_TPU_OVERLAYS = {
    # dual-K occupancy split: +54% edges/s, Hits@K within noise
    # (results/parity_sbm.jsonl lb256 A/B; BENCH_NOTES.md round-1 3rd cont.)
    ("collab", "cn5"): dict(k_small=16),
    ("collab", "cn7"): dict(k_small=16),
    ("collab", "plnlp"): dict(k_small=16),
    # ppa memory plan for N=576k / E~60M directed: round 4's GATHER-ONLY A^2
    # layout (graph_from_numpy(gather_only=True): indptr/deg/packed only,
    # 4 B/entry instead of 16-20) fits cap 1024 single-chip — ~2.4 GB versus
    # the ~9.5 GB full layout that forced cap 256 in round 3 (whose measured
    # accuracy risk — ~1 sigma val Hits + 1/3 diverged seeds on the deg-100
    # proxy, results/parity_ppa_deg100.jsonl — this closes; VERDICT r3
    # item 4).
    ("ppa", "cn5"): dict(k_small=16, adj2_cap=1024),
    ("ppa", "cn7"): dict(k_small=16, adj2_cap=1024),
    # Pubmed frame-width plan: the half-scale A/B (results/
    # parity_pubmed_half.jsonl, round 5) is the one graph in the study
    # matrix where exact semantics beat the pad-64 production caps on val
    # (heavier Zipf tail; pad 64 binds).  pad 128 recovers ~30-40% of the
    # gap (val Hits@50 0.0731 -> 0.0799, exact 0.0965 at 1 seed) for ~1.3x
    # step cost — caps are a TPU-native knob, free to widen per-dataset.
    ("Pubmed", "cn5"): dict(pad_deg=128, pad_deg2=128),
    ("Pubmed", "cn7"): dict(pad_deg=128, pad_deg2=128),
    # citation2 memory plan: N=2.9M makes the A^2 table dominant.  At the
    # round-4 gather-only layout cap 256 is ~3 GB and measured
    # throughput-identical to cap 128 at full scale (20.5k edges/s both,
    # BENCH_NOTES r4 queue 3), so the preset takes the accuracy headroom.
    ("citation2", "cn5"): dict(adj2_cap=256),
    ("citation2", "cn7"): dict(adj2_cap=256),
    ("citation2", "spd"): dict(adj2_cap=256, two_hop_mode="sddmm"),
}


def presets(dataset: str, predictor: str = "cn5", tpu_overlay: bool = True,
            **overrides) -> Config:
    """Config for the reference README command at (dataset, predictor).

    The README layer is field-for-field faithful to README.md:24-98 (pinned
    by tests/test_presets.py); the driver layer adds the stack the reference
    script wires in; ``tpu_overlay=True`` (default) adds the TPU performance/
    memory knobs, which never touch reference flags.  ``predictor`` may also
    be a driver alias ("spd", "plnlp") whose preset pins its own real
    predictor key.
    """
    key = (dataset, predictor)
    base = dict(_README_PRESETS.get(key, {}))
    base.update(_DRIVER_OVERLAYS.get(key, {}))
    if tpu_overlay:
        base.update(_TPU_OVERLAYS.get(key, {}))
    base["dataset"] = dataset
    if "predictor" not in base:
        base["predictor"] = predictor
    base.update(overrides)
    return Config(**base)


# ---------------------------------------------------------------------------
# What the port refuses: what the JAX package refuses (its asserts), and
# unknown values.
# ---------------------------------------------------------------------------

def require_supported(cfg: Config) -> None:
    """Raise ValueError naming the first field whose value the JAX package
    refuses too: the node-sharded step (dp_devices * tp_devices > 1 with
    graph_sharding="node") takes tp_devices 1, the frame-based predictors,
    two_hop_mode="gather", and neither the window table nor hoisted frames
    (ocn_tpu/train/loop.py:895, parallel/sharded_graph.py:510-520); and
    unknown values of the enumerated fields."""
    if cfg.graph_sharding not in ("replicated", "node"):
        raise ValueError(f"Config.graph_sharding={cfg.graph_sharding!r}")
    if cfg.graph_sharding == "node" and cfg.dp_devices * cfg.tp_devices > 1:
        from ocn_tpu_torch.nn.predictors import FRAME_BASED

        refused = (
            ("tp_devices", cfg.tp_devices != 1, "uses dp only"),
            ("predictor", cfg.predictor not in FRAME_BASED,
             "covers the frame-based predictors (cn1, cn5-cn9)"),
            ("two_hop_mode", cfg.two_hop_mode != "gather",
             "needs the precomputed A^2 (two_hop_mode='gather')"),
            ("window_table", cfg.window_table, "takes no window table"),
            ("hoist_frames", cfg.hoist_frames, "takes no hoisted frames"),
        )
        for field, bad, why in refused:
            if bad:
                raise ValueError(
                    f"Config.{field}={getattr(cfg, field)!r}: graph_sharding="
                    f"'node' {why}, as in the JAX package")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"Config.dtype={cfg.dtype!r}")
    if cfg.two_hop_mode not in ("gather", "sddmm"):
        raise ValueError(f"Config.two_hop_mode={cfg.two_hop_mode!r}")
    if cfg.encoder_stack not in ("ts", "ho"):
        raise ValueError(f"Config.encoder_stack={cfg.encoder_stack!r}")

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ocn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds; any failure raises
and the script exits nonzero:

1. build   - compile the CUDA kernels (nvcc, sm_90a) and the host graph
             library (g++) from the checkout, in parallel; print the card's
             name and power limit as nvidia-smi reports them.
2. kernels - every kernel against its plain PyTorch version on the card at
             the shapes the main path gives it (the window gather exactly:
             it is a copy), then timed beside its bound and, where one
             PyTorch call computes the same function, that call: ``ms`` is
             the per-call time of the wrapper (CUDA events over 200 calls),
             ``device_ms`` the kernel's own time on the card (CUDA events
             around 50 calls queued behind a spin kernel, so that the card
             runs them back to back, divided by the calls).  The sorted
             segment sum (csrc/segment_sum.cu) is held against its plain
             version in float64 (rtol 1e-5 of the terms' magnitudes in
             float32, 1e-2 with bfloat16 rows) on ragged and empty segments,
             hub rows of 12,000 and 400,000 entries and H from 1 to 256, two
             calls bit-identical; then timed at the encoder SpMM's shape.
3. reference - the slices at a tiny size on the card against the same
             slices on the CPU (plain versions), same initial weights, one
             case at a time (reference_cases, run_reference_case): the plain
             path, the window path with ELL tables and the dual-K split,
             the grouped bfloat16 program, then two steps each of cn7 (also
             with the window table), cn8, cn9, cn1, cn6 (A^3 table, dual-K)
             and hoisted cn5, then of the "ho" stack on ppa (Embedding
             input, path-count cn2, maskinput, ELL tables, dual-K) and on
             citation2 (randint-target negatives, MRR), and of the SDDMM
             two-hop mode (the spd preset's exactly-distance-2 counts), and
             of the incomplete family on the tables: cn2 and cn3 (depth 1,
             the blocked recursion), cn2 at depth 2 (the generic route) and
             cn2 with the learnable pt: losses, Hits or MRR and eval scores
             compared.
3b. cli_slice - ocn_tpu_torch.cli.run on presets("Cora", "cn5") at its own
             width (puregcn, hidden 256), 2 epochs of one run with savemod,
             save_gemb, a checkpoint_dir and a profile_dir, in a temporary
             working directory: the Chrome trace must name the membership
             kernel, rec/puregcn_cn5/metrics.jsonl hold both epochs, a
             second run with loadmod restore the saved step's parameters,
             buffers and Adam state bit for bit, an evaluate of the restored
             state (its epoch's ELL tables rebuilt) equal the one run 1
             logged, and ocn_tpu_torch.train.hpo.main run 2 trials at 1
             epoch.  It runs this early because torch.profiler's trace keeps
             fewer of a short window's kernels as the process ages.
4. slice   - the main path at full width: synthetic collab (scale 1.0,
             BFS-relabelled), the 3-layer gcn encoder with LN/res/JK at
             hidden 256, cn5 with pad_deg 64 / pad_deg2 64 and the host A^2
             capped at 1024, maskinput, batch 65536 in link chunks of 4096,
             ELL tables, dual-K split and window table off: three training
             steps through Trainer.train_step, then one Trainer.evaluate.
             Kernel launch counts are read around it, and one chunk is
             re-scored with membership routed to its plain version.
5. window_slice - the same model and dataset with the window-table path on
             (ELL tables refreshed per epoch, k_small 16 with dual-K eval,
             window_table): one timed ELL refresh, three training steps and
             one evaluate, launch counts of both kernels read around the
             steps and around the eval, and one small-body and one big-body
             chunk re-scored with the window gather routed to its plain
             version.
6. bench_slice - bench.py's own program (bench.py:96-151 at its defaults):
             ELL tables, k_small 16, frame_group 8, bfloat16 features,
             window table off.  One timed ELL refresh, three steps and one
             evaluate; x must be bfloat16 and h float32, membership must
             launch exactly twice per frame group of each step, and one
             group is re-scored with membership routed to its plain version.
             Membership's launches by (rows, Kq, Ks) are printed
             (``membership_shapes``), then one further batch is stepped
             twice, timed and under torch.profiler: the card's busy share
             of the step, its ten kernels with the most device time and the
             device ms of the segment sum and of PyTorch's index and
             scatter kernels (``step_profile``).
6a. segment_sum_shapes - the segment-sum kernel on the inputs bench_slice
             gave it, one call a (site, entries, segments, columns): held
             against its plain version in float64 and timed beside its
             bound, its plain version and index_add_ of the same products.
6b. determinism - one seed, one result: bench_slice's program (three steps
             and one evaluate), arm 1 of the accuracy study (all 24 epochs
             through run_one) and one family_slice cn3 step, each run twice
             from seed 0 in fresh objects: every loss, parameter, buffer,
             Adam moment and eval score bit for bit equal (torch.equal of
             the bits), with no global switch.  A program that differs is
             run twice more with a checksum of every aten op's output, which
             names the first op apart, and the phase fails.
6c. mesh_slice - bench_slice's program (BENCH_PATH, the same batches) at
             dp_devices 2 x tp_devices 2: four ranks (parallel/launch.py)
             sharing the card over gloo (NCCL takes one rank a card; the
             rule is fixed before launch and printed), each scoring its dp
             share of every chunk with its tp share of h.  A timed ELL
             refresh, three steps and one evaluate on each rank; the losses
             held against bench_slice's (step 1 rtol 1e-4, all 1e-3); per
             rank the step ms, peak GB, membership launches and the
             collectives' calls and bytes by op.
6d. node_sharded_slice - the same program with graph_sharding "node" on
             two ranks, the eval splits cut to EVAL_CUT rows: graph shards,
             ELL shards, the dual-K split with the round-robin interleave,
             sharded eval.  Each rank's graph bytes on the card against the
             single-device path's, the halo rows an encoder layer ships,
             step ms, peak GB, membership launches, and each rank's first
             small-body chunk re-scored with the kernel and with its plain
             version (1e-5).  Each launch first runs its reference case on
             every rank, on the CPU and on the card from the same weights
             (the mesh step at dp 2 x tp 2 on the plain case, the
             node-sharded step at dp 2 on the tables with the dual-K split),
             held at rtol 1e-4: the reference_ranks line.  A rank that fails
             fails the launch; a collective waits at most RANK_TIMEOUT_S.
7. ocnp_slice - the reference README's collab OCNP command,
             presets("collab", "cn7"): 1-layer gin with res at hidden 256,
             testbs 131072, the valid edges as input for the test split,
             ELL tables and k_small 16.  Three steps and one evaluate;
             membership exactly twice per chunk; one small-body and one
             big-body chunk re-scored with the plain version.
8. cn6_slice - bench.py's program with OCN_BENCH_PREDICTOR=cn6: the host
             A^3 build (seconds, nnz), its ELL table, three steps and one
             evaluate, membership exactly three times per chunk, two chunks
             re-scored with the plain version.
9. hoist_slice - bench.py's program with OCN_BENCH_HOIST=1 (cn5): three
             steps and one evaluate, membership exactly twice a step at
             2 * 65536 rows, the step's one group re-scored.
10. variants_slice - bench.py's program with cn1, cn8, cn9 and cn5 with
             cndeg 32: one step and one evaluate each; then one train_epoch
             of cn2 (family_slice's cut train split, three steps) at epoch 7
             with increasealpha, whose alpha2 must read 0.2.
11. presets_slice - each of the 16 README preset keys, presets(dataset,
             predictor): a fresh Trainer, one step and one evaluate (MRR for
             citation2), Cora, Citeseer, Pubmed, ddi and collab at synthetic
             scale 1.0, ppa and citation2 at PRESET_SCALE; every split cut
             to its first EVAL_CUT rows (MRR: PRESET_MRR_CUT sources).
12. family_slice - the incomplete family on bench.py's program with
             OCN_BENCH_PREDICTOR=cn2, then cn3, and OCN_BENCH_RECK=16: the
             same model and dataset as bench_slice (ELL tables, k_small 16,
             bfloat16 x), the recursion at rec_k 16 with trndeg 8 and
             tstdeg 128, the train split cut to the links of its three
             steps and every eval split to EVAL_CUT rows.  A timed ELL
             refresh (and host A^2 for cn3), three steps and one evaluate at
             testbs 65536 each; membership exactly FAMILY_LAUNCHES a chunk,
             in training and in eval; the largest lookup's expanded query
             bytes; one small-body and one big-body chunk re-scored with the
             plain version.
12a. eval_bench - the port's eval instrument (ocn_tpu_torch/scripts/
             bench_eval.py) at its defaults on family_slice's dataset: the
             collab program at batch and testbs 65536, cn5, bfloat16 x, the
             ELL tables built once from default_rng(1), and one Trainer whose
             ell_eval and dual_k_eval are set arm by arm (both, ELL alone,
             neither), each arm a warm and a timed evaluate over every eval
             split (1,320,615 scored links).  Per arm its seconds, edges/s,
             Hits@K, membership launches by shape and peak memory, and the
             script's line; valid and test Hits@50 within 1e-3 across the
             arms, membership launched in every arm and its plain version
             never on the card, and one dual-K eval chunk of the first arm
             re-scored with the plain version (1e-5).
12b. bench_program - the port's bench program (ocn_tpu_torch/scripts/
             bench.py main(), in-process, as python -m runs it) at its full
             defaults: synthetic collab at scale 1.0, cn5, gcn x 3 at hidden
             256, bfloat16 x, ELL tables, k_small 16, frame_group 8, batch
             65,536, 10 timed steps after a warm-up, the two anchors; its
             JSON line, membership launches (> 0) and peak memory; then its
             OCN_BENCH_WINDOW=1 OCN_BENCH_PAIR=0 variant, which must launch
             the window gather.
12c. accuracy_slice - arm 1 of the accuracy study through the port's
             instrument (ocn_tpu_torch/scripts/accuracy_parity.py run_one):
             sbm at scale 1.0, cn5, capped_ell, seed 0, all 24 epochs,
             evaluated every third.  The last epoch's loss below the
             first's, membership launched and its plain version never run
             on the card, and the best test Hits@50 at least
             ACCURACY_MIN_HITS50, half of the JAX package's mean on the arm.
             Its line holds the instrument's record.
12d. scaling_bench - the port's weak-scaling harness (ocn_tpu_torch/
             scripts/bench_scaling.py) at S_PERDEV 512 in its three modes
             (the explicit DP step, the bare node-sharded step, node sharding
             through the Trainer with ELL shards and the dual-K interleave)
             at dp 1, 2 and 4 (SCALING_DPS; the script's own default adds 8):
             one launch of dp ranks a dp, every mode in each rank, ranks
             sharing the card (gloo; dp 1, one rank, takes NCCL).  Per mode
             and dp the script's line (the slowest rank's ms a step,
             edges/s, efficiency against dp 1), each rank's losses and
             membership launches; every loss finite, membership launched in
             every rank and mode, its plain version never on the card.
13. ppa_slice - bench.py's ppa shape (bench.py:118-151): the 1-layer "ho"
             gcn at hidden 64 on synthetic ppa (integer features, BFS-
             relabelled) at PPA_SCALE, path-count cn2, batch 16384 in chunks
             of 512, k_small 16 (the split does not engage: no ppa node has
             degree <= 16), frame_group 8, the host A^2 capped at 1024
             (seconds, entries, host and device bytes; its path counts pass
             the col|count packing limit, so the ELL tables stay off, as in
             the JAX package).  Three steps and one evaluate over splits cut
             to EVAL_CUT rows; membership exactly twice per frame group; one
             group re-scored.
14. citation2_slice - bench.py's citation2 shape (bench.py:110-114): the
             3-layer "ho" puregcn at hidden 64 on synthetic citation2 at
             scale 1.0, path-count cn2, randint-target negatives, batch
             32768 in chunks of 2048, A^2 capped at 128.  Three steps, then
             evaluate_mrr over the first MRR_CUT valid and test sources;
             membership exactly twice per frame group; one group re-scored.
15. spd_slice - presets("citation2", "spd") at its own width: the 5-layer
             "ho" gcn at hidden 32, exactly-distance-2 counts in the SDDMM
             mode (no A^2, no ELL table) on the same dataset and MRR cut.
             Membership exactly once per chunk (cn1; the counts' lookup is
             past _COMPARE_LIMIT and takes the binary search); one chunk
             re-scored.
15b. mrr_bench - the port's MRR instrument (ocn_tpu_torch/scripts/
             bench_mrr.py) at its defaults: bench.py's citation2 shape on
             synthetic citation2 at scale 0.25 (BFS-relabelled; made by a
             worker), the valid and test splits cut to 8,192 sources with
             1,000 negatives each from default_rng(1) (16,400,384 scored
             links), testbs 65536; a warm and a timed evaluate_mrr.  Its
             seconds, links/s, MRR (finite, in (0, 1]), whether the ELL
             tables ran, membership launches by shape (its plain version
             never on the card) and peak memory, and the script's line.
16. membership_shapes - the membership kernel at each (rows, Kq, Ks) that
             phases 6-15b launched: exact against its plain version with
             unit weights, then timed beside its bound.
17. gather_bench - the row-gather instrument ocn_tpu_torch.scripts.bench_gather
             at its full size (the three gather kernels of
             scripts/bench_gather.py on the card); each kernel must launch.

The datasets of phases 13-15b are made in three worker processes while the
card runs phases 1-12d; their lines give the workers' seconds and the wait.
Every model phase prints step_ms, losses, train_edges_per_s, eval_s, hits
(or mrr), its membership launches (per step, in eval, by shape), its
segment-sum launches (per step, in eval) and peak device memory (train and eval apart where both run); the phases on new
datasets also the seconds of their data, BFS relabel and trainer set-up.  Phase 2 also holds the row
gather, the sorted-block gather and the window gather at bfloat16 against
their plain versions, exactly, at the instrument's shapes and at ragged
ones.

The third line from the end is {"kernels": [...]}, the next one the
nvidia-smi line, and the last line {"ok": true, "device": {...}}.  Without a
CUDA device, or outside the repository, it exits nonzero and prints no
result.
"""
import collections
import contextlib
import dataclasses
import io
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
# float32 rate outside the tensor cores for the compare-and-add work
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

# the model phases' device (tests/test_torch_chip_smoke.py rehearses them
# on the CPU)
DEVICE = "cuda"

# the three settings of the window-table path (bench.py with
# OCN_BENCH_WINDOW=1, its default ELL tables and k_small)
WINDOW_PATH = dict(ell_tables=True, ell_refresh=1, ell_eval=True, k_small=16,
                   dual_k_eval=True, window_table=True)
# bench.py's own program: its defaults add frame_group 8 and bfloat16 to the
# ELL tables and k_small, and leave the window table off
BENCH_PATH = dict(WINDOW_PATH, window_table=False, frame_group=8,
                  dtype="bfloat16")
# bench.py's program with OCN_BENCH_PREDICTOR=cn6 (bench.py:102): cn6 is
# never grouped, though its split still rounds to whole groups of 8
CN6_PATH = dict(BENCH_PATH, predictor="cn6")
# and with OCN_BENCH_HOIST=1 (bench.py:99): the frames of the whole step in
# one build, which turns the dual-K split off
HOIST_PATH = dict(BENCH_PATH, hoist_frames=True)
# the variants variants_slice steps on bench.py's program: cn1, cn8, cn9,
# and cn5 with its CN sets capped at 32 lanes (cndeg)
VARIANTS = (("cn1", {}), ("cn8", {}), ("cn9", {}),
            ("cn5_cndeg32", dict(predictor="cn5", cndeg=32)))
# bench.py's program with OCN_BENCH_PREDICTOR=cn3 or cn2 and
# OCN_BENCH_RECK=16 (bench.py:102,150): the incomplete family takes no frame
# groups (its split still rounds to whole groups of 8), no window table
FAMILY_PATH = dict(BENCH_PATH, rec_k=16)
# membership launches a chunk on the family's blocked route: cn2 looks up
# N(i) in N(j) and back (2) and scores each residual set (2 blocked calls
# of 1 lookup); cn3 adds the A^2 row of j and back (2 more) and scores four
# residual sets (4 blocked calls of 2 lookups each: N and A^2)
FAMILY_LAUNCHES = {"cn2": 2 + 2 * 1, "cn3": 4 + 4 * 2}
# bench.py's per-dataset shapes (bench.py:110-128), on its own program
PPA_SHAPE = dict(dataset="ppa", model="gcn", hiddim=64, mplayers=1,
                 encoder_stack="ho", cn2_counts=True, ln=False, res=False,
                 jk=False, gnndp=0.1, xdp=0.1, tdp=0.1, gnnedp=0.1, predp=0.1,
                 preedp=0.0, batch_size=16384, testbs=16384,
                 linkbatchsize=512, adj2_cap=1024)
CITATION2_SHAPE = dict(dataset="citation2", model="puregcn", hiddim=64,
                       encoder_stack="ho", cn2_counts=True,
                       neg_mode="randint_target", batch_size=32768,
                       testbs=32768, linkbatchsize=2048, adj2_cap=128)
# synthetic scales: ppa_slice's (the host A^2 at cap 1024 over 576,289 nodes
# of degree ~100 costs minutes of set-up at 1.0), and the ppa and citation2
# keys of presets_slice (their full-size shapes are phases 12-14)
PPA_SCALE = 0.5
PRESET_SCALE = 0.05
# eval cuts: every split of a Hits dataset to its first EVAL_CUT rows, the
# citation2 MRR to its first MRR_CUT (PRESET_MRR_CUT in presets_slice) valid
# and test sources with their 100 negatives each; citation2's train split
# keeps TRAIN_CUT edges, three of its 32,768-link batches and more
EVAL_CUT = 65536
MRR_CUT = 16384
PRESET_MRR_CUT = 2048
TRAIN_CUT = 131072


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms over a region (index_add_ and the other
    scatter-adds then sum in one order on the card), the setting restored
    after.  Two scorings of the same chunks that differ in one kernel are
    compared under it: with atomic scatter-adds, a column sum that nearly
    cancels (the incomplete family's 1 / colsum) turns their run-to-run
    order into differences above the comparison's 1e-5."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn) -> dict:
    """The kernel's own time on the card: 50 calls queued behind a spin
    kernel, so that the card runs them back to back, timed by CUDA events
    (each wrapper launches one kernel a call and nothing else)."""
    from ocn_tpu_torch.utils import profiling

    return {"device_ms": profiling.queued_device_ms(fn)}


def bound(nbytes: int, ops: int) -> dict:
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def phase_build():
    from ocn_tpu_torch.ops import membership, row_gather, segment_sum, window_gather
    from ocn_tpu_torch.utils import native, toolchain

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        kernels = [pool.submit(m.build)
                   for m in (membership, window_gather, row_gather, segment_sum)]
        host = pool.submit(toolchain.build_graphcore)
        kernel_libs = [k.result() for k in kernels]
        host_lib = host.result()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernel_libs": [os.path.relpath(p) for p in kernel_libs],
          "native_lib": os.path.relpath(host_lib),
          "native_loaded": native.loaded(), "nvidia_smi": smi})
    return smi


def membership_inputs(gen, lead, kq, ks, n_ids, unit_w):
    q = torch.randint(0, n_ids, lead + (kq,), generator=gen, device="cuda",
                      dtype=torch.int32)
    ids = torch.randint(0, n_ids, lead + (ks,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids = torch.sort(ids, dim=-1).values.contiguous()
    w = (torch.ones(lead + (ks,), device="cuda") if unit_w else
         torch.rand(lead + (ks,), generator=gen, device="cuda"))
    return q, ids, w


def membership_checks(gen):
    from ocn_tpu_torch.ops.membership import (
        membership_counts, membership_counts_plain)

    # (leading dims, Kq, Ks, id range, unit weights): cn1/cn2 at the train
    # chunk, cn1 at a k2_dst of 16, the eval batch, a frame group, a ragged
    # B with many duplicate ids, (B, R, K) leading dims, Kq not a multiple
    # of 4, Ks past one shared-memory tile, and Kq*Ks near 32,768
    cases = [
        ((4096,), 64, 64, 235868, False),
        ((4096,), 64, 16, 235868, False),
        ((65536,), 64, 64, 235868, False),
        ((32768,), 16, 16, 235868, False),
        ((300,), 16, 32, 77, True),
        ((512, 8), 64, 16, 5000, True),
        ((1001,), 3, 5, 7, True),
        ((1001,), 1, 600, 40, True),
        ((517,), 16, 2000, 300, True),
        ((333,), 64, 500, 200, False),
    ]
    max_err = 0.0
    rows = []
    for lead, kq, ks, n_ids, unit_w in cases:
        q, ids, w = membership_inputs(gen, lead, kq, ks, n_ids, unit_w)
        got = membership_counts(q, ids, w)
        torch.cuda.synchronize()
        want = membership_counts_plain(q, ids, w)
        err = (got - want).abs().max().item()
        if unit_w:
            if not torch.equal(got, want):
                raise AssertionError(f"membership {lead}x{kq}x{ks}: not exact ({err})")
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        max_err = max(max_err, err)
        rows.append({"shape": list(lead) + [kq, ks], "max_abs_err": err})

    return rows, max_err, membership_timing(gen, 4096, 64, 64)


def membership_timing(gen, b, kq, ks):
    """membership_counts at (b, kq, ks): per call, on the card alone, the
    plain version, and the bound."""
    from ocn_tpu_torch.ops.membership import (
        membership_counts, membership_counts_plain)

    q, ids, w = membership_inputs(gen, (b,), kq, ks, 235868, False)
    return {"shape": [b, kq, ks],
            "ms": cuda_time_ms(lambda: membership_counts(q, ids, w)),
            **device_ms(lambda: membership_counts(q, ids, w)),
            "plain_ms": cuda_time_ms(lambda: membership_counts_plain(q, ids, w)),
            # one compare and one add per (b, k, s)
            **bound(b * (4 * kq + 8 * ks) + 4 * b * kq, 2 * b * kq * ks)}


def window_checks(gen):
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.utils import profiling

    # the hoisted table of the full-width slice: one row per adjacency entry
    # (GATHER_PAD tail included), hidden 256, float32
    e, h = 1_324_714, 256
    y = torch.randn((e, h), generator=gen, device="cuda")
    rows, max_err = [], 0.0

    def check(y, b, k, label, itype=torch.int32):
        nonlocal max_err
        e = y.shape[0]
        top = max(e - k, 0)
        # int64 starts as ops/frame.py passes them: column 0 of the (B, K)
        # window positions, a strided view
        pos = torch.randint(0, top + 1, (b, 1), generator=gen, device="cuda",
                            dtype=itype) + torch.arange(k, device="cuda",
                                                        dtype=itype)
        pos0 = pos[:, 0] if itype == torch.int64 else pos[:, 0].contiguous()
        # the first row; the last start (its aligned start clamps to E - J);
        # starts in the last 8 rows, where off != pos0 mod 8
        edge = [0, top, max(top - 1, 0), max(top - 3, 0), max(top - 7, 0)]
        pos0[:len(edge)] = torch.tensor(edge[:b], device="cuda", dtype=itype)
        want, woff = W.window_rows_plain(y, pos0, k)
        if not torch.equal(woff, W.aligned_starts(pos0, e, k)[1]):
            raise AssertionError(f"window_rows {label}: plain offsets")
        got, goff = W.window_rows(y, pos0, k)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # a copy: exact
        if not (torch.equal(got, want) and torch.equal(goff, woff)):
            raise AssertionError(f"window_rows {label}: differs from plain ({err})")
        max_err = max(max_err, err)
        rows.append({"case": label, "shape": [b, k + W.SLACK, y.shape[1]],
                     "dtype": str(y.dtype), "starts": str(itype),
                     "max_abs_err": err})

    # the train chunk's big and small bodies (int32 and strided int64
    # starts), and the eval batch
    for b, k, itype in ((4096, 64, torch.int32), (4096, 64, torch.int64),
                        (4096, 16, torch.int32), (65536, 64, torch.int64)):
        check(y, b, k, f"B={b} K={k}", itype)
    # ten windows a table row
    check(y[:20000], 200_000, 16, "B=200000", torch.int64)
    # ragged: E < J with an odd width (every window clamps, 4-byte units);
    # odd bfloat16 rows (2-byte units); odd byte rows; a table whose pointer
    # is 4 bytes off 16-byte alignment
    check(torch.randn((5, 7), generator=gen, device="cuda"), 6, 4, "E<J odd H")
    check(torch.randn((1000, 33), generator=gen, device="cuda").bfloat16(),
          100, 16, "bf16 H=33")
    check(torch.randint(0, 255, (300, 13), generator=gen, device="cuda",
                        dtype=torch.uint8), 50, 8, "uint8 H=13")
    flat = torch.randn(2000 * 64 + 1, generator=gen, device="cuda")
    check(flat[1:].view(2000, 64), 300, 64, "unaligned pointer")

    # the timed starts come from a generator of their own, so that the
    # bound (which counts their distinct rows) stays put when checks change
    tgen = torch.Generator(device="cuda").manual_seed(2)
    timings = []
    for b, k in ((4096, 64), (4096, 16)):
        pos0 = torch.randint(0, e - k + 1, (b,), generator=tgen, device="cuda",
                             dtype=torch.int32)
        timings.append(window_timing(y, pos0, k))
    # a call is one device kernel: no start arithmetic around it (the trace
    # can drop activities, never add them)
    names = profiling.kernel_names(lambda: W.window_rows(y, pos0, 16), 20)
    if len(names) > 20 or any("window_rows_kernel" not in n for n in names):
        raise AssertionError(f"window_rows: {len(names)} device activities in "
                             f"20 calls: {sorted({n[:60] for n in names})}")
    timings[0]["traced_activities_in_20_calls"] = len(names)
    return rows, max_err, timings


def window_timing(y, pos0, k):
    """window_rows timed beside its plain version, one index_select of the
    same rows (indices built outside the timing) and its bound: each
    distinct row of the windows read once (overlapping windows share rows),
    the rows written, the starts read and the offsets written."""
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.scripts.bench_gather import gather_bytes

    (e, h), b, j = y.shape, pos0.shape[0], k + W.SLACK
    p0a, _ = W.aligned_starts(pos0, e, k)
    idx = torch.clamp(p0a.long()[:, None]
                      + torch.arange(j, device="cuda"), max=e - 1).reshape(-1)
    rb = h * y.element_size()
    src = y[:b * j]
    dst = torch.empty_like(src)
    return {"shape": [b, j, h], "dtype": str(y.dtype),
            "ms": cuda_time_ms(lambda: W.window_rows(y, pos0, k)),
            **device_ms(lambda: W.window_rows(y, pos0, k)),
            "plain_ms": cuda_time_ms(lambda: W.window_rows_plain(y, pos0, k)),
            "library_ms": cuda_time_ms(lambda: torch.index_select(y, 0, idx)),
            # a contiguous Tensor.copy_ of as many bytes, each read and
            # written once: what a copy reaches on this card
            "copy_ms": cuda_time_ms(lambda: dst.copy_(src)),
            **bound(gather_bytes(distinct(idx), b * j, rb,
                                 pos0.element_size() * b + 4 * b), 0)}


def distinct(t: torch.Tensor) -> int:
    return int(torch.unique(t).numel())


def exact(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference of a copy against its plain version; raises
    unless the two are equal."""
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: differs from its plain version ({err})")
    return err


def instrument_ids():
    """The row-gather instrument's ids (its seed-0 NumPy draw, the first of
    scripts/bench_gather.py), sorted, and its table's shape."""
    from ocn_tpu_torch.scripts import bench_gather as G

    s = G.SIZES
    idx = np.random.default_rng(0).integers(0, s["n"], size=(s["m"],),
                                            dtype=np.int32)
    return idx, np.sort(idx), s


def row_checks(gen, x, idx_np, srt_np):
    """row_rows against its plain version, exactly: at the instrument's shape
    on random and sorted ids, on a float32 table, at odd widths with a
    ragged M and int64 ids, with ids out of range, on an unaligned table."""
    from ocn_tpu_torch.ops import row_gather as RG
    from ocn_tpu_torch.scripts import bench_gather as G

    n, h = x.shape
    m = idx_np.shape[0]
    idx = torch.as_tensor(idx_np, device="cuda")
    idx_sorted = torch.as_tensor(srt_np, device="cuda")
    rows, max_err = [], 0.0

    def check(x, ids, label):
        nonlocal max_err
        got = RG.row_rows(x, ids)
        torch.cuda.synchronize()
        max_err = max(max_err, exact(f"row_rows {label}", got,
                                     RG.row_rows_plain(x, ids)))
        rows.append({"case": label, "shape": list(got.shape),
                     "dtype": str(x.dtype), "ids": str(ids.dtype)})

    def ids(n, m, dtype=torch.int32):
        return torch.randint(0, n, (m,), generator=gen, device="cuda", dtype=dtype)

    check(x, idx, "instrument, random ids")
    check(x, idx_sorted, "instrument, sorted ids")
    check(x.float(), idx, "float32")
    # 66-byte rows (2-byte units, 32 threads a row) with M not a multiple of
    # a block's 8 rows; 52-byte rows (4-byte units, 16 threads) on int64 ids
    check(torch.randn((1000, 33), generator=gen, device="cuda").bfloat16(),
          ids(1000, 4097), "bf16 H=33, M=4097")
    check(torch.randn((300, 13), generator=gen, device="cuda"),
          ids(300, 1001, torch.int64), "f32 H=13, int64 ids")
    bad = ids(n, 1000)
    bad[5], bad[6] = n + 7, -3  # clamped to the last and the first row
    check(x, bad, "ids out of range")
    flat = torch.randn(2000 * 64 + 1, generator=gen, device="cuda")
    check(flat[1:].view(2000, 64), ids(2000, 3000), "unaligned pointer")

    rb = h * x.element_size()
    timing = {"shape": [m, h], "dtype": str(x.dtype),
              "ms": cuda_time_ms(lambda: RG.row_rows(x, idx)),
              **device_ms(lambda: RG.row_rows(x, idx)),
              "plain_ms": cuda_time_ms(lambda: RG.row_rows_plain(x, idx)),
              "library_ms": cuda_time_ms(lambda: torch.index_select(x, 0, idx)),
              "sorted_ms": cuda_time_ms(lambda: RG.row_rows(x, idx_sorted)),
              "sorted_library_ms": cuda_time_ms(
                  lambda: torch.index_select(x, 0, idx_sorted)),
              **bound(G.gather_bytes(distinct(idx), m, rb, 4 * m), 0)}
    return rows, max_err, timing


def sorted_block_checks(gen, x, srt_np, s):
    """sorted_block_rows against its plain version, exactly: at the
    instrument's shape, and on a small table with ids outside their tile's
    block, a ragged last tile clamped at N - W, int32 and int64 ids."""
    from ocn_tpu_torch.ops import row_gather as RG
    from ocn_tpu_torch.scripts import bench_gather as G

    n, h = x.shape
    m, ts, w = srt_np.shape[0], s["ts"], s["w"]
    ids = torch.as_tensor(srt_np, device="cuda")
    bases = torch.as_tensor(G.tile_bases(srt_np, n, ts, w), device="cuda")
    rows, max_err = [], 0.0

    def check(x, ids, bases, ts, w, label):
        nonlocal max_err
        got = RG.sorted_block_rows(x, ids, bases, ts, w)
        torch.cuda.synchronize()
        max_err = max(max_err, exact(
            f"sorted_block_rows {label}", got,
            RG.sorted_block_rows_plain(x, ids, bases, ts, w)))
        rows.append({"case": label, "shape": list(got.shape), "ts": ts, "w": w,
                     "ids": str(ids.dtype)})
        return got

    got = check(x, ids, bases, ts, w, "instrument")
    # every id lies in its tile's block (the span check), so it is a gather
    exact("sorted_block_rows against index_select", got,
          torch.index_select(x, 0, ids))

    n2, ts2, w2 = 3000, 64, 320
    small = np.sort(np.random.default_rng(1).integers(0, n2, size=1297))
    small[-40:] = np.sort(np.random.default_rng(2).integers(n2 - 30, n2, size=40))
    b2 = G.tile_bases(small, n2, ts2, w2)
    if b2[-1] != n2 - w2:
        raise AssertionError("the last tile's base should clamp at N - W")
    small[70] = b2[1] + w2 + 3   # past its block
    small[130] = b2[2] - 2       # below its block
    x2 = torch.randn((n2, 256), generator=gen, device="cuda").bfloat16()
    for dtype in (torch.int32, torch.int64):
        out = check(x2, torch.as_tensor(small, dtype=dtype, device="cuda"),
                    torch.as_tensor(b2, dtype=dtype, device="cuda"), ts2, w2,
                    f"ragged, out of block, clamped, {dtype}")
        if out[70].any() or out[130].any() or not out[71].any():
            raise AssertionError("sorted_block_rows: out-of-block rows not zero")

    rb = h * x.element_size()
    timing = {"shape": [m, h], "ts": ts, "w": w, "dtype": str(x.dtype),
              "ms": cuda_time_ms(lambda: RG.sorted_block_rows(x, ids, bases, ts, w)),
              **device_ms(lambda: RG.sorted_block_rows(x, ids, bases, ts, w)),
              "plain_ms": cuda_time_ms(
                  lambda: RG.sorted_block_rows_plain(x, ids, bases, ts, w)),
              "library_ms": cuda_time_ms(lambda: torch.index_select(x, 0, ids)),
              # every id lies in its block, so all its distinct rows are read
              **bound(G.gather_bytes(distinct(ids), m, rb,
                                     4 * m + 4 * bases.numel()), 0)}
    return rows, max_err, timing


def window_bf16_checks(gen, s):
    """window_rows at the instrument's window shape: a bfloat16 table of
    E2 rows, B2 windows of K2 (gather_w of scripts/bench_gather.py)."""
    from ocn_tpu_torch.ops import window_gather as W

    e2, h, b2, k2 = s["e2"], s["h"], s["b2"], s["k2"]
    y = torch.randn((e2, h), generator=gen, device="cuda").bfloat16()
    pos0 = torch.randint(0, e2 - k2, (b2,), generator=gen, device="cuda",
                         dtype=torch.int32)
    got, goff = W.window_rows(y, pos0, k2)
    torch.cuda.synchronize()
    want, woff = W.window_rows_plain(y, pos0, k2)
    err = exact("window_rows bf16", got, want)
    exact("window_rows bf16 offsets", goff, woff)
    return err, window_timing(y, pos0, k2)


def segment_sum_case(gen, lens, n_src, h, idx_dtype=None, scaled=False,
                     dtype=torch.float32, lead=0, tail=0, planes=False):
    """Inputs of one segment sum on the card: segments of ``lens`` entries
    after ``lead`` entries of none and before ``tail`` more; rows of an
    (n_src, h) table through random int32/int64 ``idx`` (None: one row an
    entry), scales if ``scaled``; ``planes`` reads the table as the
    transposed view of (h, rows) planes, as the frames' column sums do."""
    lens = torch.as_tensor(lens, dtype=torch.int64, device="cuda")
    off = lead + torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    q = int(off[-1]) + tail
    idx = (None if idx_dtype is None else torch.randint(
        0, n_src, (q,), generator=gen, device="cuda", dtype=idx_dtype))
    rows = n_src if idx is not None else q
    src = (torch.randn((h, rows), generator=gen, device="cuda").T if planes else
           torch.randn((rows, h), generator=gen, device="cuda")).to(dtype)
    scale = torch.randn(q, generator=gen, device="cuda") if scaled else None
    return src, off, idx, scale


def ragged_lens(gen, nseg, hub=0, hub_at=None):
    """nseg segment lengths in 0..8, a third of them empty, and one of
    ``hub`` entries."""
    lens = torch.randint(1, 9, (nseg,), generator=gen, device="cuda")
    lens = lens * (torch.rand(nseg, generator=gen, device="cuda") > 0.33)
    if hub:
        lens[nseg // 2 if hub_at is None else hub_at] = hub
    return lens


def segment_sum_check(label, src, off, idx, scale):
    """The kernel against its plain version in float64 on the same inputs:
    |kernel - plain| <= rtol * (the sum of the terms' magnitudes), rtol 1e-5
    for float32 rows and 1e-2 for bfloat16 ones; two calls bit-identical.
    Returns the largest absolute error."""
    from ocn_tpu_torch.ops import segment_sum as SS

    got = SS.segment_sum_raw(src, off, idx, scale)
    again = SS.segment_sum_raw(src, off, idx, scale)
    torch.cuda.synchronize()
    if not torch.equal(bits(got), bits(again)):
        raise AssertionError(f"segment_sum {label}: two calls differ")
    sc64 = None if scale is None else scale.double()
    want = SS.segment_sum_plain(src.double(), off, idx, sc64)
    mag = SS.segment_sum_plain(src.double().abs(), off, idx,
                               None if sc64 is None else sc64.abs())
    rtol = 1e-2 if src.dtype == torch.bfloat16 else 1e-5
    err = (got.double() - want).abs()
    if not bool((err <= rtol * mag + 1e-30).all()):
        raise AssertionError(f"segment_sum {label}: off by {err.max().item()}")
    return err.max().item()


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as integers of its width: equal bits, equal tensors
    (NaN included)."""
    if not t.is_floating_point():
        return t
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def segment_sum_checks(gen):
    """segment_sum_raw against its plain version (segment_sum_check): ragged
    and empty segments, H in {1, 5, 16, 64, 256}, with and without idx and
    scale, int32 and int64 idx, segments of one entry, a hub row of 12,000
    entries, one of 400,000 (the frames' sentinel lanes), entries outside
    every segment, trailing empty segments (the column sums' ranks), strided
    planes, bfloat16 rows; subnormal sums flush to zero; then timed at the
    encoder SpMM's shape."""
    f32, bf16, i32, i64 = torch.float32, torch.bfloat16, torch.int32, torch.int64
    ones = torch.ones(20000, dtype=torch.int64)
    cases = [
        ("ragged, H=1, rows", ragged_lens(gen, 5000), 0, 1, None, False, f32, {}),
        ("ragged, H=64, int64 idx, scale", ragged_lens(gen, 5000), 3000, 64, i64,
         True, f32, {}),
        ("ragged, H=256, int32 idx, scale", ragged_lens(gen, 3000), 3000, 256, i32,
         True, f32, {}),
        ("one entry a segment, H=64", ones, 5000, 64, i32, False, f32, {}),
        ("hub of 12,000, H=256", ragged_lens(gen, 2000, 12000), 3000, 256, i32,
         True, f32, {}),
        ("hub of 12,000, H=1", ragged_lens(gen, 2000, 12000), 3000, 1, i64, True,
         f32, {}),
        ("sentinel of 400,000, H=5 planes", ragged_lens(gen, 4000, 400000, -1),
         500000, 5, i64, False, f32, {"planes": True}),
        ("sentinel of 400,000, H=256", ragged_lens(gen, 1000, 400000, -1), 3000,
         256, i32, False, f32, {}),
        ("outside entries, H=16", ragged_lens(gen, 900), 700, 16, i64, True, f32,
         {"lead": 5, "tail": 11}),
        ("trailing empties, H=3", torch.cat([ragged_lens(gen, 1000),
                                            torch.zeros(30000, dtype=torch.int64,
                                                        device="cuda")]),
         4000, 3, i64, False, f32, {}),
        ("bf16 rows, H=64, scale", ragged_lens(gen, 3000), 3000, 64, i32, True,
         bf16, {}),
        ("bf16 rows and out, H=256, hub", ragged_lens(gen, 2000, 12000), 0, 256,
         None, False, bf16, {}),
    ]
    rows, max_err = [], 0.0
    for label, lens, n_src, h, idx_dtype, scaled, dtype, kw in cases:
        src, off, idx, scale = segment_sum_case(gen, lens, n_src, h, idx_dtype,
                                                scaled, dtype, **kw)
        err = segment_sum_check(label, src, off, idx, scale)
        if dtype == f32:
            max_err = max(max_err, err)
        rows.append({"case": label, "entries": int(off[-1]), "segments": len(lens),
                     "h": h, "max_abs_err": err, "bit_identical": True})
    # subnormal terms and sums flush to zero, as index_add_'s atomics and
    # XLA's sums do (a column sum of underflowing probabilities is 0)
    from ocn_tpu_torch.ops import segment_sum as SS

    tiny = torch.tensor([3e-39, 4e-39, 2e-30, 3e-30], device="cuda")
    exact("segment_sum subnormals", SS.segment_sum_raw(tiny, torch.tensor(
        [0, 2, 4], device="cuda")), torch.stack([tiny[0] * 0, tiny[2] + tiny[3]]))
    rows.append({"case": "subnormal sums flush to zero", "exact": True})
    return rows, max_err, segment_sum_timing(*spmm_shape_inputs(gen), "SpMM")


def spmm_shape_inputs(gen, n=235868, nnz=1324714, h=256):
    """The encoder SpMM's segment sum on a random graph of the collab
    stand-in's size: rows sorted, random columns (int32), float32 values."""
    row = torch.sort(torch.randint(0, n, (nnz,), generator=gen, device="cuda")).values
    from ocn_tpu_torch.ops import segment_sum as SS

    off = SS.sorted_offsets(row, n)
    col = torch.randint(0, n, (nnz,), generator=gen, device="cuda", dtype=torch.int32)
    x = torch.randn((n, h), generator=gen, device="cuda")
    val = torch.rand(nnz, generator=gen, device="cuda")
    return x, off, col, val


def segment_sum_timing(src, off, idx, scale, label):
    """segment_sum_raw on these inputs: per call, on the card alone, its
    plain version, index_add_ of the same products into the same rows (the
    library call, the products formed outside the timing), and the bound:
    each distinct row read once, the indices, scales and offsets once, the
    float32 output written once."""
    from ocn_tpu_torch.ops import segment_sum as SS

    s2 = src[:, None] if src.dim() == 1 else src
    q = idx.numel() if idx is not None else s2.shape[0]
    nseg, h = off.numel() - 1, s2.shape[1]
    seg = SS.entry_segments(off, q)
    msg = (s2 if idx is None else s2[idx.long()]).float()
    if scale is not None:
        msg = scale[:, None] * msg
    out = torch.zeros(nseg + 1, h, device="cuda")
    used = idx[int(off[0]):int(off[-1])] if idx is not None else None
    rows_read = distinct(used) if used is not None else int(off[-1] - off[0])
    nbytes = (rows_read * h * s2.element_size() + 4 * nseg * h + 8 * (nseg + 1)
              + q * ((idx.element_size() if idx is not None else 0)
                     + (4 if scale is not None else 0)))
    timing = {"shape": [q, nseg, h], "site": label,
              "ms": cuda_time_ms(lambda: SS.segment_sum_raw(src, off, idx, scale)),
              **device_ms(lambda: SS.segment_sum_raw(src, off, idx, scale)),
              "plain_ms": cuda_time_ms(
                  lambda: SS.segment_sum_plain(src, off, idx, scale), iters=20),
              "library_ms": cuda_time_ms(lambda: out.index_add_(0, seg, msg), iters=20),
              **bound(nbytes, 2 * q * h)}
    del msg, out, seg
    return timing


def phase_kernels():
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    m_rows, m_err, m_timing = membership_checks(gen)
    w_rows, w_err, w_timings = window_checks(gen)
    torch.cuda.empty_cache()
    idx_np, srt_np, s = instrument_ids()
    x = torch.randn((s["n"], s["h"]), generator=gen, device="cuda").bfloat16()
    r_rows, r_err, r_timing = row_checks(gen, x, idx_np, srt_np)
    b_rows, b_err, b_timing = sorted_block_checks(gen, x, srt_np, s)
    wb_err, wb_timing = window_bf16_checks(gen, s)
    del x
    torch.cuda.empty_cache()
    s_rows, s_err, s_timing = segment_sum_checks(gen)
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "checks": m_rows, "membership_timing": m_timing,
          "window_checks": w_rows, "window_timing": w_timings,
          "row_checks": r_rows, "row_timing": r_timing,
          "sorted_block_checks": b_rows, "sorted_block_timing": b_timing,
          "window_bf16_timing": wb_timing, "segment_sum_checks": s_rows,
          "segment_sum_timing": s_timing})
    return {"membership": (m_err, m_timing), "window": (w_err, w_timings),
            "row": (r_err, r_timing), "sorted_block": (b_err, b_timing),
            "window_bf16": (wb_err, wb_timing), "segment_sum": (s_err, s_timing)}


REFERENCE_DATA = ("Cora", "ppa", "citation2")


def reference_dataset(name):
    """The tiny BFS-relabelled dataset of the reference cases: synthetic
    Cora at scale 0.3, or ppa and citation2 cut to 640 train links (and 256
    eval rows, 32 MRR sources)."""
    from ocn_tpu_torch.data.loaders import synthetic_dataset

    if name == "Cora":
        return synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()
    if name == "ppa":
        return cut_splits(synthetic_dataset("ppa", seed=0, scale=0.0005), 640,
                          256).reorder_bfs()
    return cut_splits(synthetic_dataset("citation2", seed=0, scale=0.00015), 640,
                      32).reorder_bfs()


def reference_cases():
    """The reference cases in order: {name: (config, epochs, dataset name)}.

    The plain path (no frame cap binds, so no random stream is read), then
    the window-table path with ELL tables and the dual-K split (capped rows
    ride the tables, whose offsets come from NumPy, so again no stream is
    read), then bench.py's grouped bfloat16 program on the tables:
    frame_group 2 over a split that the group rounding moves (4 + 3 chunks
    become 3 + 3) and bfloat16 features; three epochs each.  Then, two steps
    each (one epoch), the new predictors on the tables with the dual-K
    split: cn7 (also with the window table), cn8, cn9, cn1, cn6 (with its
    A^3 table), and hoisted cn5; their valid-edge scores are compared too.
    Then two steps each of the "ho" stack: on ppa (Embedding input,
    path-count cn2, maskinput, ELL tables, dual-K), on citation2
    (randint-target negatives, MRR on 32 sources), and in the SDDMM mode on
    citation2 (the spd preset's exactly-distance-2 counts; no tables, so its
    caps sit above every degree).  Then two steps each of the incomplete
    family on the tables with the dual-K split: cn2, cn3 (both at depth 1,
    the blocked recursion at rec_k 8), cn2 at depth 2 (its depth-1 recursion
    takes the generic route) and cn2 with the learnable pt; the residual
    caps sit at the frame width and A^2's table is as wide as its row
    gather, so again no stream is read."""
    from ocn_tpu_torch.config import Config

    base = Config(model="gcn", mplayers=2, hiddim=32, ln=True, res=True,
                  jk=True, use_xlin=True, tailact=True, gnndp=0.0, xdp=0.0,
                  tdp=0.0, gnnedp=0.0, predp=0.0, preedp=0.0, maskinput=True,
                  batch_size=256, linkbatchsize=128, testbs=512, pad_deg=64,
                  pad_deg2=256, ell_tables=False, k_small=0)
    window = dataclasses.replace(
        base, linkbatchsize=32, testbs=128, pad_deg=32, pad_deg2=16,
        ell_tables=True, k_small=8, window_table=True)
    grouped = dataclasses.replace(
        window, window_table=False, frame_group=2, dtype="bfloat16",
        small_frac=0.5, small_frac_neg=0.375)
    # an epoch is two steps of 8 + 8 chunks
    tables = dataclasses.replace(window, window_table=False, batch_size=512,
                                 linkbatchsize=64)
    cases = [("plain", base, 3), ("window", window, 3), ("grouped", grouped, 3),
             ("cn7", dataclasses.replace(tables, predictor="cn7", sum=27.29), 1),
             ("cn7_window", dataclasses.replace(tables, predictor="cn7",
                                                window_table=True), 1),
             ("cn8", dataclasses.replace(tables, predictor="cn8"), 1),
             ("cn9", dataclasses.replace(tables, predictor="cn9", polyfirst=3), 1),
             ("cn1", dataclasses.replace(tables, predictor="cn1"), 1),
             ("cn6", dataclasses.replace(tables, predictor="cn6"), 1),
             ("hoisted_cn5", dataclasses.replace(tables, hoist_frames=True), 1)]
    cases = [(name, cfg, epochs, "Cora") for name, cfg, epochs in cases]
    ho = dataclasses.replace(tables, encoder_stack="ho", cn2_counts=True,
                             gnnedp=0.3, batch_size=256, linkbatchsize=32,
                             pad_deg=16, pad_deg2=16)
    cases += [
        ("ppa", dataclasses.replace(ho, dataset="ppa", mplayers=1, res=False,
                                    small_frac=0.25, small_frac_neg=0.25), 1, "ppa"),
        ("citation2", dataclasses.replace(
            ho, dataset="citation2", model="puregcn", mplayers=3,
            neg_mode="randint_target", maskinput=False), 1, "citation2"),
        ("spd", dataclasses.replace(
            ho, dataset="citation2", two_hop_mode="sddmm", exact_two_hop=True,
            neg_mode="randint_target", maskinput=False, pad_deg=64,
            pad_deg2=64, k_small=0), 1, "citation2")]
    fam = dataclasses.replace(tables, predictor="cn2", pad_deg2=32, rec_k=8,
                              trndeg=32, tstdeg=32)
    cases += [("cn2", fam, 1, "Cora"),
              ("cn3", dataclasses.replace(fam, predictor="cn3"), 1, "Cora"),
              ("cn2_depth2", dataclasses.replace(fam, depth=2), 1, "Cora"),
              ("cn2_learnpt", dataclasses.replace(fam, learnpt=True), 1, "Cora")]
    return {name: (cfg, epochs, data) for name, cfg, epochs, data in cases}


def run_reference_case(name, datasets=None):
    """One reference case, card against CPU from the same weights: losses,
    Hits@50 (MRR for citation2) and, after one epoch, the valid-edge scores
    held together (rtol 1e-4).  On the CPU (DEVICE "cpu", the rehearsal)
    the case runs once: a run compared with itself proves nothing.
    ``datasets`` maps dataset names to the ones built already; returns the
    case's keys of the phase's line."""
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.train.loop import Trainer

    cfg, epochs, data = reference_cases()[name]
    ds = datasets[data] if datasets and data in datasets else reference_dataset(data)
    valid = ds.split_edge["valid"]["edge"]
    losses, hits, scores = {}, {}, {}
    for dev in dict.fromkeys(("cpu", DEVICE)):
        tr = Trainer(cfg, ds, device=dev)
        if name == "plain" and (int(tr.g.deg.max()) > cfg.pad_deg
                                or int(tr.adj2.deg.max()) > cfg.pad_deg2):
            raise AssertionError("reference graph exceeds the frame caps")
        if name in ("window", "cn6", "ppa", "citation2", "cn2", "cn3",
                    "cn2_depth2", "cn2_learnpt") and not (
                tr._use_ell and tr._split):
            raise AssertionError(f"{name} reference: tables or split off")
        if name == "spd" and (tr.adj2 is not None
                              or int(tr.g.deg.max()) > cfg.pad_deg):
            raise AssertionError("spd reference: an A^2, or a cap binds")
        if name == "grouped" and (tr._split != (3, 3)
                                  or tr.x.dtype != torch.bfloat16):
            raise AssertionError(f"grouped reference: split {tr._split}, "
                                 f"features {tr.x.dtype}")
        state = tr.init_state(0)
        rng = np.random.default_rng(0)
        W.window_rows.launches = 0
        losses[dev] = [tr.train_epoch(state, rng, ep)[1]
                       for ep in range(1, epochs + 1)]
        res = evaluate(tr, state)
        hits[dev] = ([res["valid"], res["test"]] if cfg.dataset == "citation2"
                     else res["Hits@50"])
        if epochs == 1:
            g, a2 = tr._eval_graphs()
            scores[dev] = tr._score_split(state, tr.encode(state), g, valid, a2)
        if name.endswith("window") and dev != "cpu" and W.window_rows.launches == 0:
            raise AssertionError(f"{name} reference: the kernel never ran")
    if not np.isfinite(losses[DEVICE] + losses["cpu"]).all():
        raise AssertionError(f"{name} reference: non-finite losses {losses}")
    np.testing.assert_allclose(losses[DEVICE], losses["cpu"], rtol=1e-4)
    np.testing.assert_allclose(hits[DEVICE], hits["cpu"], rtol=1e-4)
    if scores:
        # scores of order 1 after two Adam steps taken from float32 sums
        # in another order on each side
        np.testing.assert_allclose(scores[DEVICE], scores["cpu"],
                                   rtol=1e-4, atol=1e-4)
    prefix = "" if name == "plain" else f"{name}_"
    metric = "mrr" if cfg.dataset == "citation2" else "hits50"
    return {f"{prefix}loss_cpu": losses["cpu"],
            f"{prefix}loss_cuda": losses[DEVICE],
            f"{prefix}{metric}_cpu": hits["cpu"],
            f"{prefix}{metric}_cuda": hits[DEVICE]}


def phase_reference():
    """Every reference case (reference_cases), each dataset built once."""
    t0 = time.perf_counter()
    datasets = {name: reference_dataset(name) for name in REFERENCE_DATA}
    out = {"phase": "reference"}
    for name in reference_cases():
        out.update(run_reference_case(name, datasets))
    out["seconds"] = time.perf_counter() - t0
    emit(out)


def slice_config(**kw):
    """The model of bench.py:134-151 at full width, float32, frame_group 1,
    with the ELL tables, the dual-K split and the window table off."""
    from ocn_tpu_torch.config import Config

    return Config(**{**dict(
        dataset="collab", predictor="cn5", model="gcn", mplayers=3, hiddim=256,
        batch_size=65536, testbs=65536, linkbatchsize=4096, maskinput=True,
        ln=True, res=True, jk=True, use_xlin=True, tailact=True,
        gnndp=0.25, xdp=0.25, tdp=0.05, gnnedp=0.25, predp=0.3, preedp=0.3,
        pad_deg=64, pad_deg2=64, adj2_cap=1024, two_hop_mode="gather",
        dtype="float32", ell_tables=False, k_small=0, frame_group=1,
        hoist_frames=False), **kw})


def step_batches(tr, ds, nsteps=3):
    """Positive edges, negatives and ``nsteps`` batches of indices, from
    seed 0 as bench.py draws them (randint-target negatives keep the
    positive sources)."""
    from ocn_tpu_torch.sparse import build as B

    rng = np.random.default_rng(0)
    pos = tr.train_edges
    e = pos.shape[1]
    if tr.cfg.neg_mode == "randint_target":
        neg = np.stack([pos[0], rng.integers(0, ds.n_nodes, size=e)])
    else:
        neg = B.negative_sampling(ds.edge_index, ds.n_nodes, e, rng)
    perm = rng.permutation(e)
    bs = tr.cfg.batch_size
    return pos, neg, [perm[i * bs:(i + 1) * bs] for i in range(nsteps)]


def run_steps(tr, state, pos, neg, batches, gen):
    """Timed training steps (host clock around train_step, which ends in
    loss.item()); returns (state, step_ms, losses)."""
    step_ms, losses = [], []
    for idx in batches:
        inputs = tr.prepare_batch(pos[:, idx], neg[:, idx], idx)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        state, loss = tr.train_step(state, *inputs[:3], gen, *inputs[3:])
        losses.append(loss.item())
        step_ms.append(1e3 * (time.perf_counter() - ts))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    return state, step_ms, losses


def check_hits(results):
    """Hits@K (train, valid, test) triples, or the {"valid", "test"} MRRs,
    all in [0, 1]."""
    for key, vals in results.items():
        if not all(0.0 <= v <= 1.0 for v in np.atleast_1d(vals)):
            raise AssertionError(f"{key} out of range: {vals}")


def evaluate(tr, state):
    """The trainer's eval for its dataset, as cli.run picks it: MRR for
    citation2, Hits@K for the rest."""
    if tr.cfg.dataset == "citation2":
        return tr.evaluate_mrr(state)
    return tr.evaluate(state)


def phase_slice(ds, t_data, **overrides):
    """The plain path at full width.  ``overrides`` of slice_config shrink
    this phase and the next ones, and DEVICE moves them, for the rehearsal
    on the CPU in tests/test_torch_chip_smoke.py."""
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.ops.membership import membership_counts
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg = slice_config(**overrides)
    tr = Trainer(cfg, ds, device=DEVICE)
    state = tr.init_state(0)
    torch.cuda.synchronize()
    t_trainer = time.perf_counter() - t0

    pos, neg, batches = step_batches(tr, ds)
    e = pos.shape[1]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    membership_counts.launches = 0
    W.window_rows.launches = 0
    state, step_ms, losses = run_steps(tr, state, pos, neg, batches, gen)
    train_launches = membership_counts.launches
    chunks_per_step = 2 * cfg.batch_size // tr._chunk()
    if train_launches < 2 * chunks_per_step * len(batches):
        raise AssertionError(
            f"membership kernel launched {train_launches} times in "
            f"{len(batches)} steps; expected >= {2 * chunks_per_step * len(batches)}")
    te = time.perf_counter()
    results = tr.evaluate(state)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - te
    launches = membership_counts.launches
    window_launches = W.window_rows.launches
    check_hits(results)

    # the last step's first positive and negative chunks, eval mode, scored
    # with the kernel and with membership routed to its plain version
    score_err = rescore(tr, state, pos, neg, batches[-1], lambda pe, ne, c: [
        (pe[:, :c], 1, None), (ne[:, :c], 1, None)], 2)
    emit({"phase": "slice", "seconds": time.perf_counter() - t0,
          "data_s": t_data, "trainer_init_s": t_trainer,
          "adj2_host_build_s": tr.adj2_seconds,
          "n_nodes": ds.n_nodes, "train_edges": e, "nnz": tr.g.nnz,
          "adj2_nnz": tr.adj2.nnz, "step_ms": step_ms,
          # links scored per second (positives and negatives), as bench.py
          "train_edges_per_s": [2e3 * cfg.batch_size / ms for ms in step_ms],
          "losses": losses,
          "membership_launches_train": train_launches,
          "membership_launches_total": launches,
          "window_launches_total": window_launches, "eval_s": t_eval,
          "hits": results, "chunk_score_max_abs_err": score_err,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def phase_window_slice(ds, **overrides):
    """The window-table path at full width."""
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.ops.membership import membership_counts
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg = slice_config(**{**WINDOW_PATH, **overrides})
    tr = Trainer(cfg, ds, device=DEVICE)
    state = tr.init_state(0)
    if not (tr._use_ell and tr._split):
        raise AssertionError(f"window slice: tables {tr._use_ell}, split {tr._split}")
    torch.cuda.synchronize()
    t_trainer = time.perf_counter() - t0
    t1 = time.perf_counter()
    tr._refresh_ell(np.random.default_rng(1))
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t1

    def by_kq():
        # membership launches by query width: Kq = k_small in the small body
        out = collections.Counter()
        for (_, kq, _), n in membership_counts.shapes.items():
            out[str(kq)] += n
        return dict(out)

    pos, neg, batches = step_batches(tr, ds)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    membership_counts.launches = 0
    membership_counts.shapes.clear()
    W.window_rows.launches = 0
    state, step_ms, losses = run_steps(tr, state, pos, neg, batches, gen)
    train = {"window": W.window_rows.launches,
             "membership": membership_counts.launches,
             "membership_by_kq": by_kq()}
    peak_train = torch.cuda.max_memory_allocated() / 1e9
    membership_counts.launches = 0
    membership_counts.shapes.clear()
    W.window_rows.launches = 0
    te = time.perf_counter()
    results = tr.evaluate(state)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - te
    evals = {"window": W.window_rows.launches,
             "membership": membership_counts.launches,
             "membership_by_kq": by_kq()}
    check_hits(results)
    chunks_per_step = 2 * cfg.batch_size // tr._chunk()
    if train["window"] < chunks_per_step * len(batches):
        raise AssertionError(
            f"window kernel launched {train['window']} times in "
            f"{len(batches)} steps; expected >= {chunks_per_step * len(batches)}")
    if evals["window"] == 0:
        raise AssertionError("window kernel never launched in eval")

    # the last step's first small-body and first big-body positive chunks,
    # eval mode, scored with the kernel and with the window gather routed to
    # its plain version
    c = tr._chunk()
    nsp, _ = tr._split
    pe, ne, mp, _, _ = tr.prepare_batch(pos[:, batches[-1]], neg[:, batches[-1]],
                                        batches[-1])
    g = tr._masked_graph(mp)
    adj2 = tr._local_adj2(mp)
    kernel_rows = W.window_rows
    with torch.no_grad(), deterministic():
        h = tr.encode(state)
        y = h[g.col]
        valid = torch.ones(c, device=DEVICE)

        def chunk_scores():
            state.predictor.eval()
            small = tr._score_chunk(state, h, g, pe[:, :c], valid, None, False,
                                    adj2, corr=valid, y=y, k=cfg.k_small)
            big = tr._score_chunk(state, h, g, pe[:, nsp * c:(nsp + 1) * c],
                                  valid, None, False, adj2, corr=valid, y=y)
            return small, big

        before = W.window_rows.launches
        ks, kb = chunk_scores()
        if W.window_rows.launches != before + 2:
            raise AssertionError("re-scored chunks did not launch the kernel")
        W.window_rows = W.window_rows_plain
        try:
            ps, pb = chunk_scores()
        finally:
            W.window_rows = kernel_rows
    score_err = max((ks - ps).abs().max().item(), (kb - pb).abs().max().item())
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kb, pb, rtol=1e-5, atol=1e-5)
    emit({"phase": "window_slice", "seconds": time.perf_counter() - t0,
          "trainer_init_s": t_trainer, "ell_refresh_s": refresh_s,
          "split": list(tr._split), "window_rows": int(y.shape[0]),
          "step_ms": step_ms,
          "train_edges_per_s": [2e3 * cfg.batch_size / ms for ms in step_ms],
          "losses": losses, "launches_train": train, "launches_eval": evals,
          "eval_s": t_eval, "hits": results,
          "chunk_score_max_abs_err": score_err,
          "peak_mem_train_gb": peak_train,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return train, evals


def frame_groups(cfg, split, chunk):
    """Frame groups of one training step, as the JAX package forms them:
    the small body's nsp + nsn chunks (rounded to whole groups by the split
    plan) in groups of frame_group, the big body's in groups of eff_grp, the
    largest divisor of its chunk count <= frame_group."""
    grp = cfg.frame_group
    nsp, nsn = split or (0, 0)
    n_small = nsp + nsn
    n_big = 2 * (cfg.batch_size // chunk) - n_small
    if n_small % grp:
        raise AssertionError(f"split {split}: not whole groups of {grp}")
    eff = max((d for d in range(1, min(n_big, grp) + 1) if n_big % d == 0),
              default=1)
    return n_small // grp + n_big // eff


def phase_bench_slice(ds, **overrides):
    """bench.py's own program at full width: grouped frames and bfloat16
    features on the ELL tables and the dual-K split."""
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg = slice_config(**{**BENCH_PATH, **overrides})
    tr = Trainer(cfg, ds, device=DEVICE)
    state = tr.init_state(0)
    if not (tr._use_ell and tr._split):
        raise AssertionError(f"bench slice: tables {tr._use_ell}, split {tr._split}")
    torch.cuda.synchronize()
    t_trainer = time.perf_counter() - t0
    t1 = time.perf_counter()
    tr._refresh_ell(np.random.default_rng(1))
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t1
    with torch.no_grad():
        h_dtype = tr.encode(state).dtype
    # bfloat16 features, float32 everything after the first Dense
    if tr.x.dtype != torch.bfloat16 or h_dtype != torch.float32:
        raise AssertionError(f"bench slice: x {tr.x.dtype}, h {h_dtype}")
    groups = frame_groups(cfg, tr._split, tr._chunk())

    # a fourth batch for the profiled step, after the checks
    pos, neg, batches = step_batches(tr, ds, nsteps=4)
    batches, profiled = batches[:3], batches[3]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state, train, shapes = drive_steps(tr, state, pos, neg, batches, gen)
    # one cn_frames call per group: cn1 and cn2 membership, at group rows
    expect_launches("bench_slice", train["membership_launches_per_step"],
                    [2 * groups] * len(batches))
    evals, _ = timed_eval(tr, state)
    # the last step's first small-body group, eval mode, re-scored with
    # membership routed to its plain version
    grp = cfg.frame_group
    err = rescore(tr, state, pos, neg, batches[-1], lambda pe, ne, c: [
        (pe[:, :grp * c], grp, cfg.k_small)], 2)
    step_profile = profile_step(tr, state, pos, neg, profiled, gen)
    emit({"phase": "bench_slice", "seconds": time.perf_counter() - t0,
          "trainer_init_s": t_trainer, "ell_refresh_s": refresh_s,
          "split": list(tr._split), "frame_group": grp,
          "groups_per_step": groups, "x_dtype": str(tr.x.dtype),
          "h_dtype": str(h_dtype), **train, **evals,
          "group_score_max_abs_err": err,
          "peak_mem_gb": max(train["peak_mem_train_gb"], evals["peak_mem_eval_gb"]),
          "step_profile": step_profile})
    return (sum(train["membership_launches_per_step"])
            + evals["membership_launches_eval"]), shapes, train["losses"]


@contextlib.contextmanager
def captured_segment_sums():
    """The first segment-sum launch of each (site, entries, segments,
    columns) in a region, its inputs cloned, for timing the kernel at the
    shapes the main path gives it.  The site is the first caller outside
    ops/segment_sum.py and torch's autograd, as file:function."""
    from ocn_tpu_torch.ops import segment_sum as SS

    launch, plain = SS._launch, SS.segment_sum_plain
    seen = {}

    def capturing(fn):
        def run(src, off, idx=None, scale=None):
            f = sys._getframe(1)
            while f is not None and (f.f_code.co_filename.endswith("segment_sum.py")
                                     or f"{os.sep}torch{os.sep}" in f.f_code.co_filename):
                f = f.f_back
            site = (f"{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}"
                    if f is not None else "?")
            key = (site, idx.numel() if idx is not None else src.shape[0],
                   off.numel() - 1, src.shape[1] if src.dim() == 2 else 1)
            if key not in seen:
                seen[key] = tuple(None if t is None else t.detach().clone()
                                  for t in (src, off, idx, scale))
            seen[("launches",) + key] = seen.get(("launches",) + key, 0) + 1
            return fn(src, off, idx, scale)
        return run

    # the card's calls reach _launch, the CPU's (a rehearsal) the plain version
    SS._launch, SS.segment_sum_plain = capturing(launch), capturing(plain)
    try:
        yield seen
    finally:
        SS._launch, SS.segment_sum_plain = launch, plain


def phase_segment_sum_shapes(calls):
    """The segment-sum kernel on the inputs that bench_slice gave it (its
    three steps, evaluate, re-scored group and profiled step), one call a
    (site, entries, segments, columns): held against its plain version in
    float64 (segment_sum_check) and timed (segment_sum_timing), with the
    launches of that key in the phase."""
    t0 = time.perf_counter()
    timings, max_err = [], 0.0
    for key, args in sorted((k, v) for k, v in calls.items() if k[0] != "launches"):
        if DEVICE == "cuda":
            err = segment_sum_check(f"{key}", *args)
            timing = segment_sum_timing(*args, key[0])
        else:
            err, timing = 0.0, {"site": key[0], "shape": list(key[1:])}
        max_err = max(max_err, err)
        timings.append({**timing, "max_abs_err": err,
                        "launches": calls[("launches",) + key]})
    calls.clear()
    torch.cuda.empty_cache()
    emit({"phase": "segment_sum_shapes", "seconds": time.perf_counter() - t0,
          "timings": timings})
    return timings, max_err


@contextlib.contextmanager
def recorded_program():
    """Each training step's loss, the last stepped state and every eval
    split's scores, of whatever Trainers run in a region (Trainer.train_step
    and Trainer._score_split recorded at class level)."""
    from ocn_tpu_torch.train.loop import Trainer

    rec = {"losses": [], "scores": [], "state": None}
    step, score = Trainer.train_step, Trainer._score_split

    def train_step(self, state, *args, **kw):
        state, loss = step(self, state, *args, **kw)
        rec["losses"].append(loss.detach().clone())
        rec["state"] = state
        return state, loss

    def score_split(self, *args, **kw):
        out = score(self, *args, **kw)
        rec["scores"].append(np.array(out, copy=True))
        return out

    Trainer.train_step, Trainer._score_split = train_step, score_split
    try:
        yield rec
    finally:
        Trainer.train_step, Trainer._score_split = step, score


def program_tensors(rec, extra):
    """A recorded program as named CPU tensors: each step's loss, every
    parameter, buffer and Adam moment of the last state, each eval split's
    scores, and ``extra``."""
    out = {f"loss.{i}": t.cpu() for i, t in enumerate(rec["losses"])}
    if rec["state"] is not None:
        out.update({k: v.detach().cpu().clone()
                    for k, v in _state_tensors(rec["state"]).items()})
    out.update({f"scores.{j}": torch.as_tensor(a) for j, a in enumerate(rec["scores"])})
    return {**out, **extra}


def first_mismatch(a, b):
    """The first name whose tensors differ in a bit (or in shape or type),
    with the largest difference; None when every tensor is equal."""
    if a.keys() != b.keys():
        return {"name": "keys", "only_one": sorted(set(a) ^ set(b))}
    for name, x in a.items():
        y = b[name]
        if x.shape != y.shape or x.dtype != y.dtype:
            return {"name": name, "shapes": [list(x.shape), list(y.shape)]}
        if not torch.equal(bits(x), bits(y)):
            return {"name": name,
                    "max_abs_diff": (x.double() - y.double()).abs().max().item()}
    return None


def op_checksums(prog):
    """Run ``prog`` under a dispatch mode that keeps, for every floating
    point output of every aten op, the op's name and the float64 sum of the
    output, in the order the ops ran (forward and backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    names, sums = [], []

    class Checksums(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    names.append(str(func))
                    sums.append(t.detach().double().sum())
            return out

    with recorded_program(), Checksums():
        prog()
    return names, torch.stack(sums).cpu() if sums else torch.zeros(0)


def first_op_apart(prog):
    """The bisection of a mismatch: ``prog`` twice under op_checksums; the
    first op whose output differs while every earlier one agreed (its
    inputs then agree too, so it is itself not reproducible)."""
    (n1, s1), (n2, s2) = op_checksums(prog), op_checksums(prog)
    for i, (a, b) in enumerate(zip(n1, n2)):
        if a != b:
            return {"index": i, "op": a, "other_run_op": b}
        if not torch.equal(bits(s1[i]), bits(s2[i])):
            return {"index": i, "op": a, "ops_before": i,
                    "previous_ops": n1[max(0, i - 5):i]}
    return {"ops": len(n1), "other_run_ops": len(n2), "apart": None}


def determinism_programs(ds, accuracy_scale, accuracy_epochs, overrides):
    """The three programs of phase_determinism, each a fresh set-up from
    seed 0 returning its extra tensors."""
    from ocn_tpu_torch.scripts import accuracy_parity
    from ocn_tpu_torch.train.loop import Trainer

    def steps(cfg, dsx, nsteps, evaluate_after):
        tr = Trainer(cfg, dsx, device=DEVICE)
        state = tr.init_state(0)
        tr._refresh_ell(np.random.default_rng(1))
        pos, neg, batches = step_batches(tr, dsx, nsteps)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        state, _, _ = run_steps(tr, state, pos, neg, batches, gen)
        if evaluate_after:
            check_hits(tr.evaluate(state))
        return {}

    def bench():
        return steps(slice_config(**{**BENCH_PATH, **overrides}), ds, 3, True)

    def accuracy():
        rec = accuracy_parity.run_one(
            ACCURACY_ARM["graph"], ACCURACY_ARM["variant"], 0, accuracy_epochs,
            ACCURACY_ARM["eval_every"], ACCURACY_ARM["predictor"], accuracy_scale,
            device=DEVICE)
        return {"best_test_hits50": torch.tensor(rec["best"]["Hits@50"][2],
                                                 dtype=torch.float64),
                "epoch_losses": torch.tensor(rec["losses"], dtype=torch.float64)}

    def cn3():
        cfg = slice_config(**{**FAMILY_PATH, "predictor": "cn3", **overrides})
        return steps(cfg, family_cut(ds, cfg.batch_size, 1), 1, False)

    return {"bench_slice": bench, "accuracy_arm1": accuracy, "family_cn3": cn3}


def phase_determinism(ds, accuracy_scale=None, accuracy_epochs=None, **overrides):
    """One seed, one result: bench_slice's program (three steps and one
    evaluate), arm 1 of the accuracy study through run_one (all its
    epochs) and one step of family_slice's cn3, each run twice from seed 0
    in fresh objects.  Every step's loss, every parameter, buffer and Adam
    moment after the last step, every eval split's scores (and for arm 1
    its epoch losses and best test Hits@50) must be equal bit for bit,
    with no tolerance and no global switch.  A program that differs is run
    twice more under op_checksums to name the first op whose output
    differs (first_op_apart); then the phase fails."""
    t0 = time.perf_counter()
    scale = ACCURACY_ARM["scale"] if accuracy_scale is None else accuracy_scale
    epochs = ACCURACY_ARM["epochs"] if accuracy_epochs is None else accuracy_epochs
    out = {}
    for name, prog in determinism_programs(ds, scale, epochs, overrides).items():
        runs = []
        t1 = time.perf_counter()
        for _ in range(2):
            with recorded_program() as rec:
                extra = prog()
            runs.append(program_tensors(rec, extra))
            torch.cuda.empty_cache()
        miss = first_mismatch(*runs)
        out[name] = {"seconds": time.perf_counter() - t1, "tensors": len(runs[0]),
                     "losses": sum(k.startswith("loss.") for k in runs[0]),
                     "score_splits": sum(k.startswith("scores.") for k in runs[0]),
                     "first_mismatch": miss}
        if miss is not None:
            out[name]["first_op_apart"] = first_op_apart(prog)
        if "best_test_hits50" in runs[0]:
            out[name]["best_test_hits50"] = runs[0]["best_test_hits50"].item()
        del runs
    emit({"phase": "determinism", "seconds": time.perf_counter() - t0, **out})
    failed = [name for name, rec in out.items() if rec["first_mismatch"] is not None]
    if failed:
        raise AssertionError(f"determinism: {failed} differ between two runs of seed 0")
    return out


# arm 1 of the accuracy study (ocn_tpu_torch/scripts/accuracy_parity.py):
# the production default on the sbm learnability graph
ACCURACY_ARM = dict(graph="sbm", variant="capped_ell", predictor="cn5",
                    epochs=24, eval_every=3, scale=1.0)
# half the JAX package's mean best test Hits@50 on arm 1: seeds 0-2 on the
# CPU gave 0.15233, 0.21119 and 0.19876 (results/parity_jax_head.jsonl)
ACCURACY_MIN_HITS50 = 0.5 * 0.18743

# the multi-device phases: bench.py's program on dp x tp ranks that share the
# card (gloo: NCCL takes one rank a card), each rank a process of its own
MESH_PATH = dict(dp_devices=2, tp_devices=2)
NODE_PATH = dict(dp_devices=2, graph_sharding="node")
RANK_PATHS = {"mesh_slice": MESH_PATH, "node_sharded_slice": NODE_PATH}
# a collective's wait, and a launch's whole run, in seconds
RANK_TIMEOUT_S = 300
RANK_DEADLINE_S = 600


def rank_reference_cases():
    """The multi-device reference cases, {name: (config, epochs)}: the mesh
    step at dp 2 x tp 2 on the plain reference case, and the node-sharded
    step at dp 2 on the tables with the dual-K split (the window case with
    the window table off, which node sharding refuses)."""
    cases = reference_cases()
    plain, window = cases["plain"][0], cases["window"][0]
    return {"mesh": (dataclasses.replace(plain, **MESH_PATH), 1),
            "node_sharded": (dataclasses.replace(window, window_table=False,
                                                 **NODE_PATH), 1)}


def _count_plain_membership():
    """On the CPU (the rehearsal) the membership wrapper runs its plain
    version and counts nothing: count those calls instead, so that the
    phases' launch checks run as on the card."""
    import ocn_tpu_torch.ops.frame as frame
    from ocn_tpu_torch.ops import membership as M

    plain = M.membership_counts

    def counted(q, ids, w):
        counted.launches += 1
        return plain(q, ids, w)

    counted.launches = 0
    M.membership_counts = frame.membership_counts = counted
    return counted


def rank_reference(name, ds, devices):
    """One multi-device reference case on this rank, on each device of
    ``devices`` (the CPU first) from the same initial weights: losses and
    Hits@50."""
    from ocn_tpu_torch.train.loop import Trainer

    cfg, epochs = rank_reference_cases()[name]
    out = {}
    for dev in devices:
        tr = Trainer(cfg, ds, device=dev)
        if name == "node_sharded" and not (tr._use_ell and tr._split):
            raise AssertionError(f"{name} reference: tables or split off")
        state = tr.init_state(0)
        rng = np.random.default_rng(0)
        losses = [tr.train_epoch(state, rng, ep)[1] for ep in range(1, epochs + 1)]
        out[dev] = {"losses": losses, "hits50": tr.evaluate(state)["Hits@50"]}
    return out


def replicated_graph_bytes(tr) -> int:
    """Bytes the single-device trainer keeps on the card for the same
    graph: the full-layout adjacency, A^2 gather-only, the ELL tables, x."""
    g = tr.ds.as_graph()
    ts = [t for t in (g.indptr, g.col, g.row, g.val, g.deg, g.tpos, g.packed)
          if t is not None]
    a2 = tr.adj2
    ts += [a2.indptr, a2.deg] + ([a2.packed] if a2.packed is not None
                                 else [a2.col, a2.val])
    ell = 4 * tr.g.n_nodes * (tr.cfg.pad_deg + tr.cfg.pad_deg2) if tr._use_ell else 0
    return (sum(t.numel() * t.element_size() for t in ts) + ell
            + tr.x.numel() * tr.x.element_size())


def sharded_rescore(tr, state, pos, neg, idx, m):
    """This rank's first small-body chunk of a prepared batch, eval mode,
    scored twice against the sharded tables, with membership on the kernel
    and routed to its plain version, under deterministic algorithms, held
    together at rtol/atol 1e-5; every rank takes part (the owner-gathers
    are collective).  Returns the max abs difference."""
    import ocn_tpu_torch.ops.frame as frame
    from ocn_tpu_torch.ops.membership import membership_counts_plain

    pe, _, aux, _, _ = tr.prepare_batch(pos[:, idx], neg[:, idx], idx)
    step = tr._sharded_train()
    _, lw1, lw2, lw3 = step.graphs(step.route(aux))
    c = tr._chunk()
    start = tr.mesh.dp_rank * (pe.shape[1] // tr.mesh.dp)
    edges = pe[:, start:start + c]
    valid = torch.ones(c, dtype=tr.dtype, device=tr.device)
    kernel = frame.membership_counts
    with torch.no_grad(), deterministic():
        h = tr.encode(state)

        def scores():
            state.predictor.eval()
            return tr._score_chunk(state, h, lw1, edges, valid, None, False,
                                   lw2, adj3=lw3, k=tr.cfg.k_small)

        before = m.launches
        kern = scores()
        if m.launches != before + 2:
            raise AssertionError("the re-scored chunk did not launch membership twice")
        frame.membership_counts = membership_counts_plain
        try:
            plain = scores()
        finally:
            frame.membership_counts = kernel
    torch.testing.assert_close(kern, plain, rtol=1e-5, atol=1e-5)
    return (kern - plain).abs().max().item()


def rank_phase(info, name, ds, ref_ds, overrides):
    """One rank of mesh_slice or node_sharded_slice, after its reference
    case on this rank (CPU, then card): bench.py's program at full width on
    dp x tp ranks, a timed ELL refresh, three steps on bench_slice's batches
    and one evaluate; membership launches, the collectives' calls and bytes,
    peak memory; node_sharded_slice also the graph's bytes on the card, the
    halo, and a kernel-against-plain re-score."""
    from ocn_tpu_torch.ops import membership as M
    from ocn_tpu_torch.train.loop import Trainer

    cuda = info.device.type == "cuda"
    if cuda:
        # full float32 matrix products (no TF32), as in the parent process
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    m = M.membership_counts if cuda else _count_plain_membership()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gb(reset=False):
        if not cuda:
            return 0.0
        gb = torch.cuda.max_memory_allocated() / 1e9
        if reset:
            torch.cuda.reset_peak_memory_stats()
        return gb

    case = name.removesuffix("_slice")
    out = {"rank": info.rank, "backend": info.backend, "device": str(info.device),
           "reference": rank_reference(case, ref_ds,
                                       ("cpu", "cuda") if cuda else ("cpu",))}
    t0 = time.perf_counter()
    cfg = slice_config(**{**BENCH_PATH, **RANK_PATHS[name], **overrides})
    tr = Trainer(cfg, ds, device=info.device)
    state = tr.init_state(0)
    if not (tr._use_ell and tr._split):
        raise AssertionError(f"{name}: tables {tr._use_ell}, split {tr._split}")
    sync()
    out["trainer_init_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    tr._refresh_ell(np.random.default_rng(1))
    sync()
    out["ell_refresh_s"] = time.perf_counter() - t1
    pos, neg, batches = step_batches(tr, ds)
    gen = torch.Generator(device=info.device).manual_seed(0)
    tr.mesh.comm.reset()
    peak_gb(reset=True)
    step_ms, losses, per_step = [], [], []
    for idx in batches:
        m.launches = 0
        inputs = tr.prepare_batch(pos[:, idx], neg[:, idx], idx)
        sync()
        ts = time.perf_counter()
        state, loss = tr.train_step(state, *inputs[:3], gen, *inputs[3:])
        losses.append(loss.item())
        step_ms.append(1e3 * (time.perf_counter() - ts))
        per_step.append(m.launches)
    out.update(step_ms=step_ms, losses=losses, membership_launches_per_step=per_step,
               comm_train=tr.mesh.comm.record(), peak_mem_train_gb=peak_gb(reset=True),
               split=list(tr._split))
    tr.mesh.comm.reset()
    m.launches = 0
    te = time.perf_counter()
    results = tr.evaluate(state)
    sync()
    out.update(eval_s=time.perf_counter() - te, hits=results,
               membership_launches_eval=m.launches, comm_eval=tr.mesh.comm.record(),
               peak_mem_eval_gb=peak_gb())
    if name == "mesh_slice":
        out["row_parallel"] = sorted(tr.row_parallel_names(state))
    else:
        sh = tr._sharded_train().sh
        out.update(graph_bytes_device=sh.device_bytes(tr._ell),
                   graph_bytes_replicated=replicated_graph_bytes(tr),
                   halo_rows_per_layer=tr.mesh.dp * sh.bp.bmax,
                   halo_fraction=sh.bp.halo_fraction, rows_per=sh.rows_per,
                   rescore_max_abs_err=sharded_rescore(tr, state, pos, neg,
                                                       batches[-1], m))
    out["seconds"] = time.perf_counter() - t0
    return out


def check_rank_reference(case, ranks):
    """The card's losses and Hits@50 against the CPU's (rtol 1e-4), every
    rank alike; returns the reference_ranks keys of the case."""
    ref = ranks[0]["reference"]
    if any(r["reference"] != ref for r in ranks[1:]):
        raise AssertionError(f"{case} reference: the ranks disagree")
    if not np.isfinite(ref["cpu"]["losses"]).all():
        raise AssertionError(f"{case} reference: non-finite losses {ref}")
    if "cuda" in ref:
        np.testing.assert_allclose(ref["cuda"]["losses"], ref["cpu"]["losses"],
                                   rtol=1e-4)
        np.testing.assert_allclose(ref["cuda"]["hits50"], ref["cpu"]["hits50"],
                                   rtol=1e-4)
    out = {}
    for dev, v in ref.items():
        out[f"{case}_loss_{dev}"] = v["losses"]
        out[f"{case}_hits50_{dev}"] = v["hits50"]
    return out


RANK_KEYS = ("step_ms", "peak_mem_train_gb", "peak_mem_eval_gb", "eval_s",
             "membership_launches_per_step", "membership_launches_eval",
             "comm_train", "comm_eval", "trainer_init_s", "ell_refresh_s",
             "graph_bytes_device", "rescore_max_abs_err", "seconds")


def phase_ranks(ds, bench_losses, ref_ds, **overrides):
    """mesh_slice on four ranks, then node_sharded_slice on two (its eval
    splits cut to EVAL_CUT rows); each launch also runs its reference case
    on every rank, and one reference_ranks line follows both.  mesh_slice's
    losses are held against bench_slice's (``bench_losses``, the same
    program on one device): step 1 at rtol 1e-4, all at 1e-3 (Adam
    amplifies the ranks' other order of sums).  A rank that fails fails the
    launch.  Returns each phase's membership launches summed over ranks."""
    from ocn_tpu_torch.parallel.launch import launch

    ref_line = {"phase": "reference_ranks"}
    launches = {}
    n_train = len(ds.split_edge["train"]["edge"])
    for name, nranks, data in (("mesh_slice", 4, ds),
                               ("node_sharded_slice", 2,
                                cut_splits(ds, n_train, EVAL_CUT))):
        t0 = time.perf_counter()
        ranks = launch(rank_phase, nranks, name, data, ref_ds, overrides,
                       device=DEVICE, timeout_s=RANK_TIMEOUT_S,
                       deadline_s=RANK_DEADLINE_S)
        seconds = time.perf_counter() - t0
        ref_line.update(check_rank_reference(name.removesuffix("_slice"), ranks))
        r0 = ranks[0]
        if not all(math.isfinite(x) for x in r0["losses"]):
            raise AssertionError(f"{name}: non-finite losses {r0['losses']}")
        for r in ranks[1:]:
            np.testing.assert_allclose(r["losses"], r0["losses"], rtol=1e-6)
        check_hits(r0["hits"])
        if any(min(r["membership_launches_per_step"]) == 0
               or r["membership_launches_eval"] == 0 for r in ranks):
            raise AssertionError(f"{name}: a rank launched no membership kernel")
        launches[name] = sum(sum(r["membership_launches_per_step"])
                             + r["membership_launches_eval"] for r in ranks)
        line = {"phase": name, "seconds": seconds, "ranks": nranks,
                "backend": r0["backend"], "devices": [r["device"] for r in ranks],
                "split": r0["split"], "losses": r0["losses"], "hits": r0["hits"],
                "membership_launches": launches[name],
                "per_rank": [{k: r[k] for k in RANK_KEYS if k in r} for r in ranks]}
        if name == "mesh_slice":
            line["row_parallel"] = r0["row_parallel"]
            if bench_losses is not None:
                np.testing.assert_allclose(r0["losses"][:1], bench_losses[:1],
                                           rtol=1e-4)
                np.testing.assert_allclose(r0["losses"], bench_losses, rtol=1e-3)
                line["bench_slice_losses"] = bench_losses
        else:
            line.update({k: r0[k] for k in ("graph_bytes_replicated",
                                            "halo_rows_per_layer",
                                            "halo_fraction", "rows_per")})
        emit(line)
    emit(ref_line)
    return launches


def profile_step(tr, state, pos, neg, idx, gen):
    """One batch stepped twice: timed on the host clock, then under
    torch.profiler, which gives the card's busy time (the union of its
    kernels, copies and fills) and the ten kernels with the most device
    time.  The profiler's host-side tracing slows the launches, so the busy
    share is given against both steps: ``device_busy_share`` against the
    untraced step, ``device_busy_share_traced`` against the traced one."""
    from ocn_tpu_torch.utils import profiling

    inputs = tr.prepare_batch(pos[:, idx], neg[:, idx], idx)

    def step():
        _, loss = tr.train_step(state, *inputs[:3], gen, *inputs[3:])
        return loss.item()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    step_ms = 1e3 * (time.perf_counter() - t0)
    loss, out = profiling.profile_region(step, cuda=DEVICE == "cuda")
    if not math.isfinite(loss):
        raise AssertionError(f"profiled step: loss {loss}")
    busy = out.pop("device_busy_share")
    return {"loss": loss, "step_ms": step_ms,
            "device_busy_share": (out["device_busy_ms"] / step_ms
                                  if busy is not None else None),
            "device_busy_share_traced": busy, **out}


def shape_list(counter):
    """A membership shape counter as [[rows, Kq, Ks, launches], ...]."""
    return [[*shape, n] for shape, n in sorted(counter.items())]


def drive_steps(tr, state, pos, neg, batches, gen):
    """Timed training steps one at a time, membership launches counted per
    step and by (rows, Kq, Ks), segment-sum launches per step; returns
    (state, record, shapes)."""
    from ocn_tpu_torch.ops.membership import membership_counts
    from ocn_tpu_torch.ops.segment_sum import segment_sum_raw

    torch.cuda.reset_peak_memory_stats()
    membership_counts.shapes.clear()
    step_ms, losses, per_step, seg_per_step = [], [], [], []
    for idx in batches:
        membership_counts.launches = 0
        seg0 = segment_sum_raw.launches
        state, ms, loss = run_steps(tr, state, pos, neg, [idx], gen)
        per_step.append(membership_counts.launches)
        seg_per_step.append(segment_sum_raw.launches - seg0)
        step_ms += ms
        losses += loss
    shapes = collections.Counter(membership_counts.shapes)
    return state, {
        "step_ms": step_ms,
        "train_edges_per_s": [2e3 * tr.cfg.batch_size / ms for ms in step_ms],
        "losses": losses, "membership_launches_per_step": per_step,
        "segment_sum_launches_per_step": seg_per_step,
        "membership_shapes_train": shape_list(shapes),
        "peak_mem_train_gb": torch.cuda.max_memory_allocated() / 1e9}, shapes


def timed_eval(tr, state):
    """One evaluate (Trainer.evaluate_mrr for citation2), timed, its
    membership launches counted and its peak device memory apart from the
    training's; returns (record, shapes)."""
    from ocn_tpu_torch.ops.membership import membership_counts
    from ocn_tpu_torch.ops.segment_sum import segment_sum_raw

    torch.cuda.reset_peak_memory_stats()
    membership_counts.launches = 0
    membership_counts.shapes.clear()
    seg0 = segment_sum_raw.launches
    te = time.perf_counter()
    results = evaluate(tr, state)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - te
    check_hits(results)
    shapes = collections.Counter(membership_counts.shapes)
    return {"eval_s": t_eval,
            ("mrr" if tr.cfg.dataset == "citation2" else "hits"): results,
            "membership_launches_eval": membership_counts.launches,
            "segment_sum_launches_eval": segment_sum_raw.launches - seg0,
            "membership_shapes_eval": shape_list(shapes),
            "peak_mem_eval_gb": torch.cuda.max_memory_allocated() / 1e9}, shapes


def rescore(tr, state, pos, neg, idx, cases, per_group):
    """Score link groups of one prepared batch in eval mode twice, with
    membership on the kernel and routed to its plain version, both under
    deterministic algorithms, and hold the scores together (rtol/atol
    1e-5).  ``cases(pe, ne, chunk)`` lists the
    groups as (edges, chunks in the group, frame width or None); each group
    must launch membership ``per_group`` times."""
    import ocn_tpu_torch.ops.frame as frame
    from ocn_tpu_torch.ops.membership import (
        membership_counts, membership_counts_plain)

    pe, ne, mp, _, _ = tr.prepare_batch(pos[:, idx], neg[:, idx], idx)
    g = tr._masked_graph(mp)
    adj2, adj3 = tr._local_adj2(mp), tr._local_adj3(mp)
    c = tr._chunk()
    groups = cases(pe, ne, c)
    with torch.no_grad(), deterministic():
        h = tr.encode(state)
        y = h[g.col] if tr.cfg.window_table else None

        def scores():
            state.predictor.eval()
            out = []
            for edges, grp, k in groups:
                valid = torch.ones(edges.shape[1], dtype=tr.dtype, device=DEVICE)
                out.append(tr._score_chunk(state, h, g, edges, valid, None,
                                           False, adj2, y=y, k=k, grp=grp,
                                           adj3=adj3))
            return out

        before = membership_counts.launches
        kern = scores()
        launched = membership_counts.launches - before
        if launched != per_group * len(groups):
            raise AssertionError(f"re-scored groups launched membership "
                                 f"{launched} times, expected "
                                 f"{per_group * len(groups)}")
        frame.membership_counts = membership_counts_plain
        try:
            plain = scores()
        finally:
            frame.membership_counts = membership_counts
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    return max((a - b).abs().max().item() for a, b in zip(kern, plain))


def expect_launches(phase, got, want):
    if got != want:
        raise AssertionError(f"{phase}: membership launches per step {got}, "
                             f"expected {want}")


def with_valid_edges(ds):
    """The dataset with its train+valid graph, as loaddataset builds it for
    use_valedges_as_input."""
    from ocn_tpu_torch.sparse import build as B

    full = np.concatenate([ds.edge_index, ds.split_edge["valid"]["edge"].T], 1)
    return dataclasses.replace(
        ds, full_edge_index=B.symmetrize_edge_index(full, ds.n_nodes))


def phase_ocnp_slice(ds, nsteps=3, **overrides):
    """The reference README's collab OCNP command at full width:
    presets("collab", "cn7"), a 1-layer gin encoder with res at hidden 256,
    gnnedp 0.25, batch 65536 in chunks of 4096, testbs 131072, maskinput,
    the valid edges as input for the test split, ELL tables and k_small 16.
    Exactly two membership launches per chunk; one small-body and one
    big-body chunk re-scored with the plain version."""
    from ocn_tpu_torch.config import presets
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg = presets("collab", "cn7", **overrides)
    tr = Trainer(cfg, with_valid_edges(ds), device=DEVICE)
    state = tr.init_state(0)
    if not (tr._use_ell and tr._split) or tr.full_g is tr.g:
        raise AssertionError(f"ocnp slice: tables {tr._use_ell}, split "
                             f"{tr._split}, full graph {tr.full_g is not tr.g}")
    tr._refresh_ell(np.random.default_rng(1))
    torch.cuda.synchronize()
    t_trainer = time.perf_counter() - t0
    pos, neg, batches = step_batches(tr, ds, nsteps)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state, train, shapes = drive_steps(tr, state, pos, neg, batches, gen)
    chunks = 2 * cfg.batch_size // tr._chunk()
    expect_launches("ocnp_slice", train["membership_launches_per_step"],
                    [2 * chunks] * nsteps)
    evals, eval_shapes = timed_eval(tr, state)
    nsp, _ = tr._split
    err = rescore(tr, state, pos, neg, batches[-1], lambda pe, ne, c: [
        (pe[:, :c], 1, cfg.k_small), (pe[:, nsp * c:(nsp + 1) * c], 1, None)], 2)
    emit({"phase": "ocnp_slice", "seconds": time.perf_counter() - t0,
          "trainer_init_s": t_trainer, "split": list(tr._split),
          "config": {k: getattr(cfg, k) for k in (
              "model", "mplayers", "hiddim", "res", "jk", "gnnedp", "sum",
              "batch_size", "testbs", "k_small", "use_valedges_as_input")},
          **train, **evals, "chunk_score_max_abs_err": err,
          "peak_mem_gb": max(train["peak_mem_train_gb"], evals["peak_mem_eval_gb"])})
    return train, evals, shapes + eval_shapes


def phase_cn6_slice(ds, nsteps=3, **overrides):
    """bench.py's program with OCN_BENCH_PREDICTOR=cn6 at full width: the
    host A^3 = A^2 @ A capped at adj3_cap, its ELL table tbl3, three
    membership launches per chunk (cn1, cn2, cn3), one small-body and one
    big-body chunk re-scored with the plain version."""
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg = slice_config(**{**CN6_PATH, **overrides})
    tr = Trainer(cfg, ds, device=DEVICE)
    state = tr.init_state(0)
    if not (tr._use_ell and tr._split) or tr.adj3.packed is None:
        raise AssertionError(f"cn6 slice: tables {tr._use_ell}, split "
                             f"{tr._split}, A^3 packed {tr.adj3.packed is not None}")
    tr._refresh_ell(np.random.default_rng(1))
    torch.cuda.synchronize()
    t_trainer = time.perf_counter() - t0
    pos, neg, batches = step_batches(tr, ds, nsteps)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state, train, shapes = drive_steps(tr, state, pos, neg, batches, gen)
    chunks = 2 * cfg.batch_size // tr._chunk()
    expect_launches("cn6_slice", train["membership_launches_per_step"],
                    [3 * chunks] * nsteps)
    evals, eval_shapes = timed_eval(tr, state)
    nsp, _ = tr._split
    err = rescore(tr, state, pos, neg, batches[-1], lambda pe, ne, c: [
        (pe[:, :c], 1, cfg.k_small), (pe[:, nsp * c:(nsp + 1) * c], 1, None)], 3)
    emit({"phase": "cn6_slice", "seconds": time.perf_counter() - t0,
          "trainer_init_s": t_trainer, "adj2_host_build_s": tr.adj2_seconds,
          "adj3_host_build_s": tr.adj3_seconds,
          "adj3_nnz": int(tr.adj3.indptr[-1]), "k3": tr._k3_width(),
          "adj3_max_deg": int(tr.adj3.deg.max()), "split": list(tr._split),
          **train, **evals, "chunk_score_max_abs_err": err,
          "peak_mem_gb": max(train["peak_mem_train_gb"], evals["peak_mem_eval_gb"])})
    return train, evals, shapes + eval_shapes


def phase_hoist_slice(ds, nsteps=3, **overrides):
    """bench.py's program with OCN_BENCH_HOIST=1 (cn5): one frame build of
    all 2 * batch_size links a step, so exactly two membership launches a
    step at 131072 rows; the whole step's group re-scored with the plain
    version."""
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg = slice_config(**{**HOIST_PATH, **overrides})
    tr = Trainer(cfg, ds, device=DEVICE)
    state = tr.init_state(0)
    if tr._split is not None or not tr._use_ell:
        raise AssertionError(f"hoist slice: split {tr._split}, tables {tr._use_ell}")
    tr._refresh_ell(np.random.default_rng(1))
    torch.cuda.synchronize()
    t_trainer = time.perf_counter() - t0
    pos, neg, batches = step_batches(tr, ds, nsteps)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state, train, shapes = drive_steps(tr, state, pos, neg, batches, gen)
    expect_launches("hoist_slice", train["membership_launches_per_step"],
                    [2] * nsteps)
    rows = 2 * cfg.batch_size
    if set(shapes) != {(rows, cfg.pad_deg, cfg.pad_deg2)}:
        raise AssertionError(f"hoist slice: membership shapes {dict(shapes)}")
    evals, eval_shapes = timed_eval(tr, state)
    err = rescore(tr, state, pos, neg, batches[-1], lambda pe, ne, c: [
        (torch.cat([pe, ne], 1), rows // c, None)], 2)
    emit({"phase": "hoist_slice", "seconds": time.perf_counter() - t0,
          "trainer_init_s": t_trainer, **train, **evals,
          "group_score_max_abs_err": err,
          "peak_mem_gb": max(train["peak_mem_train_gb"], evals["peak_mem_eval_gb"])})
    return train, evals, shapes + eval_shapes


def phase_variants_slice(ds, **overrides):
    """bench.py's program with OCN_BENCH_PREDICTOR = cn1, cn8 and cn9, and
    cn5 with cndeg 32: one step and one evaluate each (cn1 and cn9 carry two
    (n_nodes, hidden) one-hot weights).  Then cn2 on the family's program
    with increasealpha: one train_epoch at epoch 7 over family_slice's cut
    train split, after which alpha2 must read the ramp's 0.2."""
    from ocn_tpu_torch.ops.membership import membership_counts
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    out, launches, shapes = {}, 0, collections.Counter()
    pos = neg = batches = None
    for name, extra in VARIANTS:
        cfg = slice_config(**{**BENCH_PATH, "predictor": name, **extra,
                              **overrides})
        tr = Trainer(cfg, ds, device=DEVICE)
        state = tr.init_state(0)
        tr._refresh_ell(np.random.default_rng(1))
        if batches is None:
            pos, neg, batches = step_batches(tr, ds, 1)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        state, train, s_train = drive_steps(tr, state, pos, neg, batches, gen)
        evals, s_eval = timed_eval(tr, state)
        launches += sum(train["membership_launches_per_step"])
        launches += evals["membership_launches_eval"]
        shapes += s_train + s_eval
        out[name] = {
            "parameters": sum(p.numel() for p in state.predictor.parameters()),
            **train, **evals,
            "peak_mem_gb": max(train["peak_mem_train_gb"], evals["peak_mem_eval_gb"])}
        del tr, state
        torch.cuda.empty_cache()

    cfg = slice_config(**{**FAMILY_PATH, "predictor": "cn2",
                          "increasealpha": True, **overrides})
    fds = family_cut(ds, cfg.batch_size)
    tr = Trainer(cfg, fds, device=DEVICE)
    state = tr.init_state(0)
    membership_counts.launches = 0
    membership_counts.shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    te = time.perf_counter()
    state, loss = tr.train_epoch(state, np.random.default_rng(0), 7)
    torch.cuda.synchronize()
    alpha2 = float(state.sched["alpha2"])
    if not math.isfinite(loss) or abs(alpha2 - 0.2) > 1e-6:
        raise AssertionError(f"cn2 epoch: loss {loss}, alpha2 {alpha2}")
    launches += membership_counts.launches
    shapes += membership_counts.shapes
    out["cn2_increasealpha_epoch7"] = {
        "epoch_s": time.perf_counter() - te, "loss": loss, "alpha2": alpha2,
        "steps": len(fds.split_edge["train"]["edge"]) // cfg.batch_size,
        "membership_launches": membership_counts.launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del tr, state
    torch.cuda.empty_cache()
    emit({"phase": "variants_slice", "seconds": time.perf_counter() - t0, **out})
    return launches, shapes


def family_cut(ds, batch_size, nsteps=3):
    """family_slice's dataset: the train split cut to the links of its
    ``nsteps`` batches, every eval split to EVAL_CUT rows."""
    return cut_splits(ds, nsteps * batch_size, EVAL_CUT)


def phase_family_slice(ds, nsteps=3, **overrides):
    """The incomplete family on bench.py's program (FAMILY_PATH), cn2 then
    cn3, over family_cut(ds): set-up (the host A^2 for cn3, a timed ELL
    refresh), ``nsteps`` steps and one evaluate each, with exactly
    FAMILY_LAUNCHES membership launches a chunk in training and a batch in
    eval, one small-body and one big-body chunk re-scored with the plain
    version; returns (launches, shapes)."""
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    out, launches, shapes = {}, 0, collections.Counter()
    for name in ("cn2", "cn3"):
        per_chunk = FAMILY_LAUNCHES[name]
        t1 = time.perf_counter()
        cfg = slice_config(**{**FAMILY_PATH, "predictor": name, **overrides})
        fds = family_cut(ds, cfg.batch_size, nsteps)
        tr = Trainer(cfg, fds, device=DEVICE)
        state = tr.init_state(0)
        torch.cuda.synchronize()
        t_trainer = time.perf_counter() - t1
        if not (tr._use_ell and tr._split) or (tr.adj2 is None) != (name == "cn2"):
            raise AssertionError(f"family slice {name}: tables {tr._use_ell}, "
                                 f"split {tr._split}, A^2 {tr.adj2 is not None}")
        t1 = time.perf_counter()
        tr._refresh_ell(np.random.default_rng(1))
        torch.cuda.synchronize()
        t_ell = time.perf_counter() - t1
        pos, neg, batches = step_batches(tr, fds, nsteps)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        state, train, s_train = drive_steps(tr, state, pos, neg, batches, gen)
        chunks = 2 * cfg.batch_size // tr._chunk()
        expect_launches(f"family_slice {name}",
                        train["membership_launches_per_step"],
                        [per_chunk * chunks] * nsteps)
        # count the eval's testbs batches as _score_split hands them out
        scored = []
        score_batches = tr._score_batches

        def counted(state, h, g, edges, *args, **kw):
            scored.append(-(-len(edges) // cfg.testbs))
            return score_batches(state, h, g, edges, *args, **kw)

        tr._score_batches = counted
        evals, s_eval = timed_eval(tr, state)
        del tr._score_batches
        if evals["membership_launches_eval"] != per_chunk * sum(scored):
            raise AssertionError(
                f"family slice {name}: {evals['membership_launches_eval']} "
                f"membership launches over {sum(scored)} eval batches, "
                f"expected {per_chunk} a batch")
        nsp, _ = tr._split
        err = rescore(tr, state, pos, neg, batches[-1], lambda pe, ne, c: [
            (pe[:, :c], 1, cfg.k_small), (pe[:, nsp * c:(nsp + 1) * c], 1, None)],
            per_chunk)
        # the blocked scorer's lookups broadcast each anchor's row over its
        # R candidates; the wrapper writes the expanded int32 queries out
        rows, kq, _ = max(s_eval, key=lambda shape: shape[0])
        out[name] = {
            "trainer_init_s": t_trainer, "ell_refresh_s": t_ell,
            "adj2_host_build_s": tr.adj2_seconds, "rec_k": tr.cfg.rec_k,
            "split": list(tr._split), "membership_launches_per_chunk": per_chunk,
            "eval_batches": sum(scored), **train, **evals,
            "largest_lookup": [rows, kq], "largest_lookup_query_gb": 4 * rows * kq / 1e9,
            "chunk_score_max_abs_err": err,
            "peak_mem_gb": max(train["peak_mem_train_gb"], evals["peak_mem_eval_gb"])}
        launches += sum(train["membership_launches_per_step"])
        launches += evals["membership_launches_eval"]
        shapes += s_train + s_eval
        del tr, state
        torch.cuda.empty_cache()
    emit({"phase": "family_slice", "seconds": time.perf_counter() - t0,
          "config": {k: getattr(cfg, k) for k in (
              "model", "mplayers", "hiddim", "batch_size", "linkbatchsize",
              "testbs", "pad_deg", "k_small", "rec_k", "trndeg", "tstdeg",
              "depth", "dtype", "predp", "preedp", "use_xlin", "tailact")},
          "split_rows": {part: {k: len(v) for k, v in d.items()}
                         for part, d in fds.split_edge.items()}, **out})
    return launches, shapes


def cut_splits(ds, n_train, n_eval):
    """The dataset with each train array cut to its first n_train rows and
    every other split's to n_eval (for citation2 that many sources with
    their rows of negatives).  The graph keeps every edge: the cut bounds
    the links an eval scores and the train links the steps draw from."""
    split = {part: {k: v[:n_train if part == "train" else n_eval]
                    for k, v in d.items()}
             for part, d in ds.split_edge.items()}
    return dataclasses.replace(ds, split_edge=split)


def new_dataset(name, scale, n_train, n_eval):
    """Synthetic ``name`` at ``scale``, its splits cut, BFS-relabelled;
    returns (dataset, {"data_s", "bfs_s"}).  The cut comes first, so the
    relabel maps only the rows that are kept."""
    from ocn_tpu_torch.data.loaders import synthetic_dataset

    t0 = time.perf_counter()
    ds = synthetic_dataset(name, seed=0, scale=scale)
    t1 = time.perf_counter()
    ds = cut_splits(ds, n_train, n_eval).reorder_bfs()
    return ds, {"data_s": t1 - t0, "bfs_s": time.perf_counter() - t1,
                "scale": scale, "n_nodes": ds.n_nodes,
                "adjacency_entries": int(ds.edge_index.shape[1]),
                "split_rows": {part: {k: len(v) for k, v in d.items()}
                               for part, d in ds.split_edge.items()}}


def host_peak_rss_gb():
    """The process's peak resident host memory so far."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def adj2_record(tr):
    """The host A^2's build seconds and entries, and the bytes of its
    gather-only layout: on the host the CSR the SpGEMM writes (column and
    count per entry, 8 B), on the card indptr, deg and the entries, packed
    col|count (4 B) where the counts fit 31 - col_bits bits, else column and
    count apart (8 B; the ELL tables then stay off)."""
    a2 = tr.adj2
    nnz = int(a2.indptr[-1])
    return {"adj2_host_build_s": tr.adj2_seconds, "adj2_nnz": nnz,
            "adj2_max_deg": int(a2.deg.max()),
            "adj2_packed": a2.packed is not None, "ell_tables": tr._use_ell,
            "adj2_max_count": (int(a2.val.max()) if a2.packed is None else
                               int((a2.packed >> a2.col_bits).max())),
            "adj2_pack_limit": 1 << (31 - max(int(a2.n_nodes - 1).bit_length(), 1)),
            "adj2_host_csr_gb": (8 * nnz + 4 * (a2.n_nodes + 1)) / 1e9,
            "adj2_device_gb": sum(t.numel() * t.element_size() for t in (
                a2.indptr, a2.deg, a2.packed, a2.col, a2.val) if t is not None) / 1e9,
            "host_peak_rss_gb": host_peak_rss_gb()}


def phase_shape_slice(name, ds, data, nsteps=3, **overrides):
    """bench.py's ppa or citation2 shape (``name`` "ppa_slice" or
    "citation2_slice") on its own program: the "ho" stack with path-count
    cn2, frame_group 8, k_small 16, ELL tables where A^2 packs; for ppa the
    Embedding input (no ppa node has degree <= 16, so the split does not
    engage), for citation2 randint-target negatives, the split, and
    evaluate_mrr over the cut sources.  Two membership launches per frame
    group; one group re-scored with the plain version."""
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    ppa = name == "ppa_slice"
    shape = PPA_SHAPE if ppa else CITATION2_SHAPE
    cfg = slice_config(**{**BENCH_PATH, **shape, **overrides})
    tr = Trainer(cfg, ds, device=DEVICE)
    state = tr.init_state(0)
    if (tr._use_ell != (tr.adj2.packed is not None)
            or (tr.x.dtype == torch.int64) != ppa or (tr._split is None) != ppa):
        raise AssertionError(f"{name}: tables {tr._use_ell}, x {tr.x.dtype}, "
                             f"split {tr._split}")
    if tr._use_ell:
        tr._refresh_ell(np.random.default_rng(1))
    torch.cuda.synchronize()
    t_trainer = time.perf_counter() - t0
    groups = frame_groups(cfg, tr._split, tr._chunk())
    pos, neg, batches = step_batches(tr, ds, nsteps)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state, train, shapes = drive_steps(tr, state, pos, neg, batches, gen)
    expect_launches(name, train["membership_launches_per_step"],
                    [2 * groups] * nsteps)
    evals, eval_shapes = timed_eval(tr, state)
    grp, k = cfg.frame_group, None if ppa else cfg.k_small
    err = rescore(tr, state, pos, neg, batches[-1],
                  lambda pe, ne, c: [(pe[:, :grp * c], grp, k)], 2)
    extra = {} if ppa else {
        "mrr_sources": {p: len(ds.split_edge[p]["source_node"])
                        for p in ("valid", "test")},
        "mrr_eval_s": evals["eval_s"]}
    emit({"phase": name, "seconds": time.perf_counter() - t0, **data,
          "trainer_init_s": t_trainer, **adj2_record(tr),
          "split": tr._split and list(tr._split), "groups_per_step": groups,
          **train, **evals, **extra, "group_score_max_abs_err": err,
          "peak_mem_gb": max(train["peak_mem_train_gb"], evals["peak_mem_eval_gb"])})
    return train, evals, shapes + eval_shapes


def phase_spd_slice(ds, nsteps=3, **overrides):
    """presets("citation2", "spd"): the SDDMM two-hop mode, no A^2 and no
    ELL table.  Membership launches once per chunk (cn1): the counts'
    lookup, (C, K*K2) queries against K2 ids, is past _COMPARE_LIMIT and
    takes the binary search.  One chunk re-scored with the plain version."""
    from ocn_tpu_torch.config import presets
    from ocn_tpu_torch.ops import frame
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg = presets("citation2", "spd", **overrides)
    tr = Trainer(cfg, ds, device=DEVICE)
    state = tr.init_state(0)
    if tr.adj2 is not None or tr.adj3 is not None or tr._use_ell:
        raise AssertionError("spd slice: an A^2, A^3 or ELL table was built")
    k, k2 = cfg.pad_deg, cfg.pad_deg2
    if k * k2 * k2 <= frame._COMPARE_LIMIT:
        raise AssertionError(f"spd slice: the counts' lookup ({k * k2} x {k2}) "
                             "would take the membership kernel")
    torch.cuda.synchronize()
    t_trainer = time.perf_counter() - t0
    pos, neg, batches = step_batches(tr, ds, nsteps)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state, train, shapes = drive_steps(tr, state, pos, neg, batches, gen)
    c = tr._chunk()
    expect_launches("spd_slice", train["membership_launches_per_step"],
                    [2 * cfg.batch_size // c] * nsteps)
    evals, eval_shapes = timed_eval(tr, state)
    if set(shapes) != {(c, k, k2)} or set(eval_shapes) != {(cfg.testbs, k, k2)}:
        raise AssertionError(f"spd slice: membership shapes {dict(shapes)} in "
                             f"training, {dict(eval_shapes)} in eval")
    err = rescore(tr, state, pos, neg, batches[-1],
                  lambda pe, ne, c: [(pe[:, :c], 1, None)], 1)
    emit({"phase": "spd_slice", "seconds": time.perf_counter() - t0,
          "trainer_init_s": t_trainer, "adj2": None, "ell_tables": False,
          "config": {key: getattr(cfg, key) for key in (
              "model", "mplayers", "hiddim", "encoder_stack", "two_hop_mode",
              "exact_two_hop", "cn2_counts", "batch_size", "linkbatchsize",
              "testbs", "pad_deg", "pad_deg2")},
          **train, **evals, "mrr_eval_s": evals["eval_s"],
          "chunk_score_max_abs_err": err,
          "peak_mem_gb": max(train["peak_mem_train_gb"], evals["peak_mem_eval_gb"])})
    return train, evals, shapes + eval_shapes


def phase_presets_slice(datasets, scale=1.0, large_scale=PRESET_SCALE,
                        eval_cut=EVAL_CUT, mrr_cut=PRESET_MRR_CUT, **overrides):
    """Each README preset key: a fresh Trainer on presets(dataset,
    predictor), one step on one batch from prepare_batch, then evaluate
    (evaluate_mrr for citation2).  ``datasets`` holds the ones built
    already (their splits whole); the others are made at ``scale`` (ppa and
    citation2 at ``large_scale``), each once.  ``overrides`` go to every
    preset, for the rehearsal on the CPU."""
    from ocn_tpu_torch.config import _README_PRESETS, presets
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    made, out, launches, shapes = {}, {}, 0, collections.Counter()
    for name, pred in sorted(_README_PRESETS):
        cfg = presets(name, pred, **overrides)
        mrr = name == "citation2"
        key = (name, cfg.use_valedges_as_input)
        if key not in made:
            if name in datasets:
                t1 = time.perf_counter()
                ds = datasets[name]
                if cfg.use_valedges_as_input:
                    ds = with_valid_edges(ds)
                ds = cut_splits(ds, eval_cut, mrr_cut if mrr else eval_cut)
                data = {"data_s": time.perf_counter() - t1, "bfs_s": 0.0}
            else:
                ds, data = new_dataset(
                    name, large_scale if name in ("ppa", "citation2") else scale,
                    eval_cut, mrr_cut if mrr else eval_cut)
            made[key] = ds, {k: data[k] for k in ("data_s", "bfs_s")}
        ds, data = made[key]
        t1 = time.perf_counter()
        tr = Trainer(cfg, ds, device=DEVICE)
        state = tr.init_state(0)
        if tr._use_ell:
            tr._refresh_ell(np.random.default_rng(1))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t1
        pos, neg, batches = step_batches(tr, ds, 1)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        state, train, s_train = drive_steps(tr, state, pos, neg, batches, gen)
        evals, s_eval = timed_eval(tr, state)
        launches += train["membership_launches_per_step"][0]
        launches += evals["membership_launches_eval"]
        shapes += s_train + s_eval
        out[f"{name}/{pred}"] = {
            "n_nodes": ds.n_nodes, **data, "setup_s": setup_s,
            "adj2_host_build_s": tr.adj2_seconds,
            "step_ms": train["step_ms"][0], "loss": train["losses"][0],
            "membership_launches_step": train["membership_launches_per_step"][0],
            **{k: evals[k] for k in ("eval_s", "membership_launches_eval")},
            ("mrr" if mrr else "hits"): evals["mrr" if mrr else "hits"],
            "peak_mem_train_gb": train["peak_mem_train_gb"],
            "peak_mem_eval_gb": evals["peak_mem_eval_gb"]}
        del tr, state
        torch.cuda.empty_cache()
    emit({"phase": "presets_slice", "seconds": time.perf_counter() - t0,
          "scales": {"ppa": large_scale, "citation2": large_scale, "others": scale},
          "eval_cut": eval_cut, "mrr_cut": mrr_cut, "keys": out})
    return launches, shapes


@contextlib.contextmanager
def bench_knobs(env):
    """Exactly the OCN_BENCH_* knobs of ``env`` set over a region, the
    ones set before restored after."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("OCN_BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(env)
    try:
        yield
    finally:
        for k in env:
            del os.environ[k]
        os.environ.update(saved)


def run_bench_program(env, anchors=None):
    """The port's bench program in-process, as ``python -m
    ocn_tpu_torch.scripts.bench`` runs it, with exactly the OCN_BENCH_*
    knobs of ``env`` set; returns its record with its JSON line, seconds,
    the kernels' launches and the peak device memory."""
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.ops.membership import membership_counts
    from ocn_tpu_torch.scripts import bench

    out = io.StringIO()
    with bench_knobs(env):
        torch.cuda.reset_peak_memory_stats()
        membership_counts.launches = 0
        W.window_rows.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rec = bench.main(anchors=anchors)
        seconds = time.perf_counter() - t0
        launches = {"membership": membership_counts.launches,
                    "window_rows": W.window_rows.launches}
    lines = [line for line in out.getvalue().splitlines() if line.startswith("{")]
    if [json.loads(line) for line in lines] != [rec]:
        raise AssertionError(f"bench program: printed {lines}, returned {rec}")
    value = rec["value"]
    if not (math.isfinite(value) and value > 0):
        raise AssertionError(f"bench program: value {value}")
    if not all(k in rec for k in ("anchor_rowgather_ms", "anchor_matmul_tflops")):
        raise AssertionError(f"bench program: no anchors in {rec}")
    return {"seconds": seconds, "env": env, "line": rec,
            "membership_launches": launches["membership"],
            "window_launches": launches["window_rows"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_bench_program(env=None, anchors=None):
    """The port's bench program (ocn_tpu_torch/scripts/bench.py) at its
    defaults, then its window-table variant (OCN_BENCH_WINDOW=1,
    OCN_BENCH_PAIR=0): the metric, a finite value above 0, both anchors,
    membership launched in the first and the window gather in the second.
    ``env`` adds knobs to both and ``anchors`` shrinks the anchors, for the
    rehearsal on the CPU; returns (membership launches, window launches)."""
    t0 = time.perf_counter()
    env = dict(env or {})
    if DEVICE == "cpu":
        env["OCN_BENCH_PLATFORM"] = "cpu"
    defaults = run_bench_program(env, anchors)
    window = run_bench_program({**env, "OCN_BENCH_WINDOW": "1",
                                "OCN_BENCH_PAIR": "0"}, anchors)
    metric = defaults["line"]["metric"]
    if metric != "train_edges_per_s_cn5_collab" or window["line"]["metric"] != metric:
        raise AssertionError(f"bench program: metrics {metric}, "
                             f"{window['line']['metric']}")
    if defaults["membership_launches"] == 0:
        raise AssertionError("bench program: membership never launched")
    if window["window_launches"] == 0:
        raise AssertionError("bench program, window variant: window_rows "
                             "never launched")
    emit({"phase": "bench_program", "seconds": time.perf_counter() - t0,
          "defaults": defaults, "window_variant": window})
    return (defaults["membership_launches"] + window["membership_launches"],
            window["window_launches"])


def _state_tensors(state):
    """Every tensor of a TrainState: module parameters and buffers, and the
    Adam state by (group, parameter index, key)."""
    out = {f"encoder.{k}": v for k, v in state.encoder.state_dict().items()}
    out.update({f"predictor.{k}": v
                for k, v in state.predictor.state_dict().items()})
    return {**out, **_opt_tensors(state.opt.state_dict())}


def _opt_tensors(opt_state):
    return {f"opt.{i}.{k}": v for i, st in opt_state["state"].items()
            for k, v in st.items()}


def _saved_tensors(path):
    saved = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"encoder.{k}": v for k, v in saved["encoder"].items()}
    out.update({f"predictor.{k}": v for k, v in saved["predictor"].items()})
    return {**out, **_opt_tensors(saved["opt"])}


def phase_cli_slice(**overrides):
    """cli.run on presets("Cora", "cn5") at its own width, 2 epochs of one
    run with savemod, save_gemb, a checkpoint_dir and a profile_dir, in a
    temporary directory that is also the working directory (rec/, gemb/):
    the Chrome trace names the membership kernel (on the card), metrics.jsonl
    holds both epochs, a second run with loadmod restores the saved step's
    parameters, buffers and Adam state bit for bit, an evaluate of the
    restored state equals the one run 1 logged for that step, and hpo.main
    runs 2 trials of the preset at 1 epoch.  The evaluations run with
    deterministic algorithms, so that the card's scatter-adds sum in one
    order.  ``overrides`` shrink the preset for the rehearsal; returns the
    membership launches of the first run."""
    import tempfile

    from ocn_tpu_torch import cli
    from ocn_tpu_torch.config import presets
    from ocn_tpu_torch.ops.membership import membership_counts
    from ocn_tpu_torch.train import checkpoint, hpo
    from ocn_tpu_torch.train.loop import Trainer, epoch_ell_rng

    t0 = time.perf_counter()
    cwd = os.getcwd()
    try:
        with deterministic(), tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            ckpt, prof = os.path.join(tmp, "ckpt"), os.path.join(tmp, "profile")
            cfg = presets("Cora", "cn5", epochs=2, runs=1, savemod=True,
                          save_gemb=True, checkpoint_dir=ckpt, profile_dir=prof,
                          **overrides)
            membership_counts.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            summary = cli.run(cfg, device=DEVICE)
            run_s = time.perf_counter() - t1
            launches = membership_counts.launches
            peak = torch.cuda.max_memory_allocated() / 1e9

            with open(os.path.join(prof, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            kernels = sorted({ev["name"] for ev in events
                              if ev.get("cat") == "kernel"})
            if DEVICE != "cpu" and not any("membership" in k for k in kernels):
                raise AssertionError(f"cli slice: no membership kernel among "
                                     f"the trace's {len(kernels)} kernel names")
            with open(os.path.join("rec", f"{cfg.model}_{cfg.predictor}",
                                   "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            scalars = [r for r in records if "step" in r]
            if {r["step"] for r in scalars} != {1, 2} or records[0]["tag"] != "hyperparams":
                raise AssertionError(f"cli slice: metrics.jsonl {records[:3]}")
            steps = sorted(int(d) for d in os.listdir(ckpt)) if os.path.isdir(ckpt) else []
            if not steps:
                raise AssertionError("cli slice: no new best validation, no checkpoint")
            step = steps[-1]
            gemb = np.load(os.path.join(
                "gemb", f"Cora_{cfg.model}_{cfg.predictor}_{cfg.hiddim}.npy"))

            # run 2 resumes; the state load_state returns is held
            restored = {}
            load_state = checkpoint.load_state

            def held(path, state, step=None):
                state, step = load_state(path, state, step)
                restored.update(step=step, tensors={
                    k: v.detach().cpu().clone()
                    for k, v in _state_tensors(state).items()})
                return state, step

            checkpoint.load_state = held
            try:
                cli.run(dataclasses.replace(cfg, loadmod=True, savemod=False,
                                            save_gemb=False, profile_dir="",
                                            epochs=1), device=DEVICE)
            finally:
                checkpoint.load_state = load_state
            want = _saved_tensors(os.path.join(ckpt, str(step), "state.pt"))
            got = restored["tensors"]
            if restored["step"] != step or got.keys() != want.keys() or not all(
                    torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"cli slice: run 2 restored step "
                                     f"{restored['step']}, not step {step} bit for bit")
            n_adam = sum(k.startswith("opt.") for k in want)

            # the restored state's evaluate against run 1's at that step
            tr = Trainer(cfg, cli.run_dataset(cfg, 0), device=DEVICE)
            state, _ = checkpoint.load_state(ckpt, tr.init_state(cfg.seed))
            if tr._use_ell:  # the saved epoch's tables (trainer state)
                tr._refresh_ell(epoch_ell_rng(step))
            results = tr.evaluate(state)
            logged = {r["tag"].rsplit("_", 1)[0]: [r["trn"], r["val"], r["tst"]]
                      for r in scalars if r["step"] == step}
            if {k: list(v) for k, v in results.items()} != logged:
                raise AssertionError(f"cli slice: restored evaluate {results} "
                                     f"vs run 1's {logged}")

            hpo_out = os.path.join(tmp, "hpo")
            argv = ["--trials", "2", "--hpo_out", hpo_out, "--dataset", "Cora",
                    "--predictor", "cn5", "--preset", "--epochs", "1", "--runs", "1"]
            argv += [f"--{k}={v}" for k, v in overrides.items()]
            if DEVICE == "cpu":
                argv += ["--platform", "cpu"]
            t1 = time.perf_counter()
            best = hpo.main(argv)
            hpo_s = time.perf_counter() - t1
            with open(os.path.join(hpo_out, "hpo_Cora_cn5.jsonl")) as f:
                trials = [json.loads(line) for line in f]
            if len(trials) != 2 or any("error" in t for t in trials):
                raise AssertionError(f"cli slice: hpo trials {trials}")
    finally:
        os.chdir(cwd)
    emit({"phase": "cli_slice", "seconds": time.perf_counter() - t0,
          "config": {k: getattr(cfg, k) for k in (
              "model", "mplayers", "hiddim", "batch_size", "testbs", "epochs")},
          "run_s": run_s, "summary": summary, "membership_launches": launches,
          "trace_kernel_names": len(kernels),
          "trace_membership_names": [k for k in kernels if "membership" in k],
          "metrics_records": len(records), "checkpoint_steps": steps,
          "resumed_step": step, "restored_tensors": len(want),
          "restored_adam_tensors": n_adam, "gemb_shape": list(gemb.shape),
          "restored_eval": results, "hpo_s": hpo_s,
          "hpo_trials": [t["val_mean"] for t in trials],
          "hpo_best_val": best["val_mean"], "peak_mem_gb": peak})
    return launches


def phase_gather_bench(**sizes):
    """The row-gather instrument; ``sizes`` shrink it for the rehearsal."""
    from ocn_tpu_torch.ops import row_gather as RG
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.scripts import bench_gather

    t0 = time.perf_counter()
    RG.row_rows.launches = 0
    RG.sorted_block_rows.launches = 0
    W.window_rows.launches = 0
    out = bench_gather.main(device=DEVICE, **sizes)
    launches = {"row_rows": RG.row_rows.launches,
                "sorted_block_rows": RG.sorted_block_rows.launches,
                "window_rows": W.window_rows.launches}
    if not all(launches.values()):
        raise AssertionError(f"gather bench: a kernel never launched {launches}")
    torch.cuda.empty_cache()
    emit({"phase": "gather_bench", "seconds": time.perf_counter() - t0,
          "launches": launches, **out})
    return launches, out["variants"]


def phase_membership_shapes(shapes):
    """membership_counts at each (rows, Kq, Ks) that the model phases
    launched in their steps and evals: exact against its plain version with
    unit weights (duplicate ids included), then timed."""
    from ocn_tpu_torch.ops.membership import (
        membership_counts, membership_counts_plain)

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    timings = []
    for b, kq, ks in sorted(shapes):
        q, ids, w = membership_inputs(gen, (b,), kq, ks, 300, True)
        got = membership_counts(q, ids, w)
        torch.cuda.synchronize()
        exact(f"membership ({b}, {kq}, {ks})", got, membership_counts_plain(q, ids, w))
        timings.append({**membership_timing(gen, b, kq, ks), "exact_unit_w": True,
                        "launches": shapes[(b, kq, ks)]})
    emit({"phase": "membership_shapes", "seconds": time.perf_counter() - t0,
          "timings": timings})
    return timings


# the phases whose membership launches make up the kernel's "launches":
# the main path and the entry points that users run it through
MEMBERSHIP_MAIN = ("slice", "bench_program", "cli_slice", "accuracy_slice",
                   "eval_bench", "mrr_bench", "scaling_bench")


def membership_entry(err, timing, by_phase, shapes):
    """Membership's entry of the kernels line: ``by_phase`` ({phase:
    launches}) as launches_<phase>, their sum over MEMBERSHIP_MAIN as
    ``launches``, the timed shapes as ``model_shapes``."""
    from ocn_tpu_torch.ops import membership

    return kernel_entry("membership_counts", membership, membership.REPLACES,
                        sum(by_phase[k] for k in MEMBERSHIP_MAIN), err, timing,
                        **{f"launches_{k}": n for k, n in by_phase.items()},
                        model_shapes=shapes)


# the phases whose segment-sum launches make up the kernel's "launches": the
# main path and the entry points that users run it through, in this process
# (the rank phases' launches happen in their ranks)
SEGMENT_SUM_MAIN = ("slice", "bench_slice", "bench_program", "cli_slice",
                    "accuracy_slice", "eval_bench", "mrr_bench")


def segment_sum_entry(err, timing, by_phase, shapes, shapes_err):
    """The segment sum's entry of the kernels line: its launches by phase
    (each phase read with the count set to 0 just before it), their sum over
    SEGMENT_SUM_MAIN as ``launches``, the bench_slice sites timed as
    ``model_shapes``; it fails if a main phase never launched it."""
    from ocn_tpu_torch.ops import segment_sum

    idle = [k for k in SEGMENT_SUM_MAIN if not by_phase.get(k)]
    if idle:
        raise AssertionError(f"segment_sum never launched in {idle}")
    return kernel_entry(
        "segment_sum", segment_sum, segment_sum.REPLACES,
        sum(by_phase[k] for k in SEGMENT_SUM_MAIN), max(err, shapes_err), timing,
        replaces_what="XLA's jax.ops.segment_sum(indices_are_sorted=True), "
                      "not a Pallas kernel",
        **{f"launches_{k}": n for k, n in by_phase.items()}, model_shapes=shapes)


def kernel_entry(name, module, replaces, launches, err, timing, **extra):
    """One entry of the {"kernels": [...]} line."""
    return {"name": name, "route": "cuda", "source": module.SOURCE,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            **{key: timing[key] for key in ("ms", "device_ms", "plain_ms",
                                            "bound_ms", "bound_by")},
            "library_ms": timing.get("library_ms"), "shape": timing.get("shape"),
            **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    # full float32 matrix products (no TF32), as the JAX reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ocn_tpu_torch.scripts import bench_mrr

    with bench_knobs({}):
        mrr_scale, mrr_cap = bench_mrr.mrr_knobs()[:2]
    # the ppa and citation2 datasets take minutes of NumPy on the host:
    # three worker processes make them (and mrr_bench's) while the card runs
    # phases 1-12d
    with ProcessPoolExecutor(max_workers=3,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {"ppa": pool.submit(new_dataset, "ppa", PPA_SCALE, EVAL_CUT,
                                   EVAL_CUT),
                "citation2": pool.submit(new_dataset, "citation2", 1.0,
                                         TRAIN_CUT, MRR_CUT),
                "mrr": pool.submit(mrr_dataset_job, mrr_scale, mrr_cap)}
        return run_phases(jobs)


def made_dataset(job):
    """A worker's (dataset, record), with the seconds the card phases then
    waited for it."""
    t0 = time.perf_counter()
    ds, data = job.result()
    return ds, {**data, "waited_s": time.perf_counter() - t0}


@contextlib.contextmanager
def plain_membership_calls():
    """Count the calls of membership's plain version over a region, by the
    device of their tensors: on the card the wrapper launches its kernel
    and never runs the plain version, which this shows."""
    from ocn_tpu_torch.ops import membership as M

    plain = M.membership_counts_plain
    calls = collections.Counter()

    def counted(q, ids, w):
        calls[q.device.type] += 1
        return plain(q, ids, w)

    M.membership_counts_plain = counted
    try:
        yield calls
    finally:
        M.membership_counts_plain = plain


def phase_accuracy_slice(scale=ACCURACY_ARM["scale"],
                         epochs=ACCURACY_ARM["epochs"]):
    """Arm 1 of the accuracy study at seed 0 through the port's instrument
    (ocn_tpu_torch/scripts/accuracy_parity.py run_one): sbm, cn5,
    capped_ell, every epoch, evaluated every third.  The last epoch's loss
    must be below the first's, membership must launch and its plain
    version never run on the card, and the best test Hits@50 must reach
    half of the JAX package's mean on this arm.  Prints the instrument's
    record; returns (membership launches, launches by shape)."""
    from ocn_tpu_torch.ops import membership as M
    from ocn_tpu_torch.scripts import accuracy_parity

    t0 = time.perf_counter()
    M.membership_counts.launches = 0
    M.membership_counts.shapes.clear()
    with plain_membership_calls() as plain:
        rec = accuracy_parity.run_one(
            ACCURACY_ARM["graph"], ACCURACY_ARM["variant"], 0, epochs,
            ACCURACY_ARM["eval_every"], ACCURACY_ARM["predictor"], scale,
            device=DEVICE)
    launches = M.membership_counts.launches
    shapes = collections.Counter(M.membership_counts.shapes)
    emit({"phase": "accuracy_slice", "seconds": time.perf_counter() - t0,
          "plain_membership_calls": dict(plain), "record": rec})
    losses, hits50 = rec["losses"], rec["best"]["Hits@50"][2]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"accuracy_slice: losses {losses}")
    if launches == 0 or rec["membership_launches"] != launches:
        raise AssertionError(f"accuracy_slice: membership launches {launches}, "
                             f"record {rec['membership_launches']}")
    if plain["cuda"]:
        raise AssertionError(f"accuracy_slice: membership's plain version "
                             f"ran {plain['cuda']} times on the card")
    if hits50 < ACCURACY_MIN_HITS50:
        raise AssertionError(f"accuracy_slice: best test Hits@50 {hits50} "
                             f"< {ACCURACY_MIN_HITS50}")
    return launches, shapes


def eval_rescore(tr, state):
    """One eval chunk of the Trainer's current arm scored with membership's
    kernel and with its plain version, both under deterministic
    algorithms: the first testbs train positives in source-degree order at
    width k_small (the dual-K split's small body), on the arm's eval graphs
    (rtol/atol 1e-5).  Returns (kernel launches of one scoring, max abs
    error)."""
    import ocn_tpu_torch.ops.frame as frame
    from ocn_tpu_torch.ops.membership import (
        membership_counts, membership_counts_plain)

    cfg = tr.cfg
    edges = np.asarray(tr.ds.split_edge["train"]["edge"])
    deg = tr.g.deg.cpu().numpy()[edges[:, 0]]
    chunk = edges[np.argsort(deg, kind="stable")[:cfg.testbs]]
    with torch.no_grad(), deterministic():
        h = tr.encode(state)
        g, a2 = tr._eval_graphs()
        before = membership_counts.launches
        kern = tr._score_batches(state, h, g, chunk, a2, k=cfg.k_small, fold0=1)
        launched = membership_counts.launches - before
        frame.membership_counts = membership_counts_plain
        try:
            plain = tr._score_batches(state, h, g, chunk, a2, k=cfg.k_small,
                                      fold0=1)
        finally:
            frame.membership_counts = membership_counts
    if launched == 0:
        raise AssertionError("eval re-score: membership never launched")
    np.testing.assert_allclose(kern, plain, rtol=1e-5, atol=1e-5)
    return launched, float(np.abs(kern - plain).max())


def phase_eval_bench(ds, env=None, **overrides):
    """The port's eval instrument (ocn_tpu_torch/scripts/bench_eval.py) at
    its defaults on the collab stand-in ``ds`` (bench_eval.eval_dataset()):
    the three arms on one live Trainer, each a warm and a timed evaluate.
    Per arm: seconds, edges/s, Hits@K, membership launches by shape, peak
    GB; valid and test Hits@50 must agree across the arms to 1e-3, the
    plain version never run on the card, and one chunk of the first arm
    re-scored with it.  ``env`` (knobs) and ``overrides`` (Config fields)
    shrink it for the rehearsal; returns (launches, launches by shape)."""
    from ocn_tpu_torch.ops import membership as M
    from ocn_tpu_torch.scripts import bench_eval

    t0 = time.perf_counter()
    with bench_knobs(env or {}):
        cfg = dataclasses.replace(bench_eval.eval_config(), **overrides)
    tr, state = bench_eval.setup(cfg, ds, DEVICE)
    n = bench_eval.n_eval(ds)
    setup_s = time.perf_counter() - t0
    arms, shapes = [], collections.Counter()
    with plain_membership_calls() as plain:
        for label, ell, dual in bench_eval.ARMS:
            torch.cuda.reset_peak_memory_stats()
            M.membership_counts.launches = 0
            M.membership_counts.shapes.clear()
            dt, res = bench_eval.run_arm(tr, state, ell, dual)
            arm_shapes = collections.Counter(M.membership_counts.shapes)
            arms.append({"arm": label, "seconds": dt, "edges_per_s": n / dt,
                         "hits": res,
                         "membership_launches": M.membership_counts.launches,
                         "membership_shapes": shape_list(arm_shapes),
                         "peak_mem_eval_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "line": bench_eval.arm_line(label, dt, n, res)})
            shapes += arm_shapes
            check_hits(res)
    # the re-score, which runs the plain version on purpose, reads the
    # first arm's flags
    tr.cfg.ell_eval, tr.cfg.dual_k_eval = bench_eval.ARMS[0][1:]
    rescore_launches, err = eval_rescore(tr, state)
    launches = sum(a["membership_launches"] for a in arms)
    emit({"phase": "eval_bench", "seconds": time.perf_counter() - t0,
          "setup_s": setup_s, "n_eval": n, "ell_tables": bool(tr._use_ell),
          "testbs": cfg.testbs, "arms": arms,
          "rescore_launches": rescore_launches, "rescore_max_abs_err": err,
          "plain_membership_calls": dict(plain)})
    for a in arms:
        print(a["line"], flush=True)
        if a["membership_launches"] == 0:
            raise AssertionError(f"eval_bench {a['arm']}: membership never launched")
    if plain["cuda"]:
        raise AssertionError(f"eval_bench: membership's plain version ran "
                             f"{plain['cuda']} times on the card")
    first = arms[0]["hits"]["Hits@50"]
    for a in arms[1:]:
        got = a["hits"]["Hits@50"]
        if max(abs(got[i] - first[i]) for i in (1, 2)) > 1e-3:
            raise AssertionError(f"eval_bench: valid/test Hits@50 {got[1:]} of "
                                 f"{a['arm']} against {first[1:]}")
    return launches, shapes


def mrr_dataset_job(scale, cap):
    """A worker's job: bench_mrr's cut citation2 stand-in and its record."""
    from ocn_tpu_torch.scripts import bench_mrr

    t0 = time.perf_counter()
    ds, n_scored = bench_mrr.mrr_dataset(scale, cap)
    return ds, {"data_s": time.perf_counter() - t0, "scale": scale, "cap": cap,
                "n_nodes": ds.n_nodes, "n_scored": n_scored}


def phase_mrr_bench(ds, data, env=None):
    """The port's MRR instrument (ocn_tpu_torch/scripts/bench_mrr.py) at
    its defaults on its dataset ``ds`` (made by mrr_dataset_job; ``data``
    its record): a warm and a timed evaluate_mrr over 1,000 negatives a
    source.  Seconds, links/s, valid and test MRR (finite, in (0, 1]),
    whether the ELL tables ran, membership launches by shape (at least one,
    the plain version never on the card) and peak GB.  ``env`` shrinks it
    for the rehearsal; returns (launches, launches by shape)."""
    from ocn_tpu_torch.ops import membership as M
    from ocn_tpu_torch.scripts import bench_mrr

    t0 = time.perf_counter()
    with bench_knobs(env or {}):
        scale, cap, testbs, adj2_cap = bench_mrr.mrr_knobs()
    tr, state = bench_mrr.setup(bench_mrr.mrr_config(testbs, adj2_cap), ds, DEVICE)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    M.membership_counts.launches = 0
    M.membership_counts.shapes.clear()
    with plain_membership_calls() as plain:
        dt, out = bench_mrr.run(tr, state)
    launches = M.membership_counts.launches
    shapes = collections.Counter(M.membership_counts.shapes)
    n_scored = data["n_scored"]
    line = bench_mrr.mrr_line(scale, ds.n_nodes, n_scored, dt, out)
    emit({"phase": "mrr_bench", "seconds": time.perf_counter() - t0,
          "setup_s": setup_s, "data": data, "testbs": testbs,
          "adj2_cap": adj2_cap, "ell_tables": bool(tr._use_ell),
          "eval_s": dt, "links_per_s": n_scored / dt, "mrr": out,
          "membership_launches": launches,
          "membership_shapes": shape_list(shapes),
          "peak_mem_eval_gb": torch.cuda.max_memory_allocated() / 1e9,
          "plain_membership_calls": dict(plain)})
    print(line, flush=True)
    if not all(math.isfinite(v) and 0.0 < v <= 1.0 for v in out.values()):
        raise AssertionError(f"mrr_bench: MRR {out}")
    if launches == 0:
        raise AssertionError("mrr_bench: membership never launched")
    if plain["cuda"]:
        raise AssertionError(f"mrr_bench: membership's plain version ran "
                             f"{plain['cuda']} times on the card")
    return launches, shapes


# the weak-scaling harness on ranks sharing the card: three of the JAX
# script's four dps (8 ranks would be 8 CUDA contexts on one card)
SCALING_DPS = (1, 2, 4)


def scaling_rank(info, *args):
    """One rank of scaling_bench: bench_scaling.rank_body with membership's
    launches by shape and its plain version's calls by device (on the CPU,
    the rehearsal, the plain calls stand in for launches)."""
    from ocn_tpu_torch.ops import membership as M
    from ocn_tpu_torch.scripts import bench_scaling

    cuda = info.device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        M.membership_counts.shapes.clear()
    else:
        _count_plain_membership()
    with plain_membership_calls() as plain:
        modes = bench_scaling.rank_body(info, *args)
    return {"rank": info.rank, "backend": info.backend, "device": str(info.device),
            "modes": modes, "plain_membership_calls": dict(plain),
            "shapes": dict(M.membership_counts.shapes) if cuda else {},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0}


def phase_scaling_bench(dps=SCALING_DPS, per_dev=512, steps=None):
    """The port's weak-scaling harness (ocn_tpu_torch/scripts/
    bench_scaling.py) in all three modes at each dp of ``dps``: one launch
    of dp ranks a dp, every mode in each rank.  Per mode and dp the
    script's line, ms a step (the slowest rank's), edges/s, efficiency, and
    each rank's losses and membership launches.  Every loss finite, every
    rank of every mode launching membership, its plain version never on
    the card.  Returns (launches over every rank, launches by shape)."""
    from ocn_tpu_torch.scripts import bench_scaling

    t0 = time.perf_counter()
    steps = steps or bench_scaling.STEPS
    by_dp, seconds = {}, {}
    for dp in dps:
        t1 = time.perf_counter()
        by_dp[dp] = bench_scaling.run_dp(
            dp, per_dev, bench_scaling.MODES, DEVICE, steps, body=scaling_rank,
            timeout_s=RANK_TIMEOUT_S, deadline_s=RANK_DEADLINE_S)
        seconds[dp] = time.perf_counter() - t1
    launches, shapes, modes = 0, collections.Counter(), {}
    for mode in bench_scaling.MODES:
        rows = bench_scaling.rows(mode, per_dev, {dp: [r["modes"] for r in ranks]
                                                  for dp, ranks in by_dp.items()})
        for row in rows:
            ranks = by_dp[row["dp"]]
            row["line"] = bench_scaling.scaling_line(
                row["dp"], row["batch"], row["ms"], row["edges_per_s"],
                row["efficiency"])
            row["losses"] = [r["modes"][mode]["losses"] for r in ranks]
            row["membership_launches"] = [r["modes"][mode]["membership_launches"]
                                          for r in ranks]
            if not all(math.isfinite(x) for ls in row["losses"] for x in ls):
                raise AssertionError(f"scaling_bench {mode} dp={row['dp']}: "
                                     f"losses {row['losses']}")
            if min(row["membership_launches"]) == 0:
                raise AssertionError(f"scaling_bench {mode} dp={row['dp']}: a "
                                     f"rank launched no membership kernel")
            launches += sum(row["membership_launches"])
        modes[mode] = rows
    for ranks in by_dp.values():
        for r in ranks:
            shapes.update({tuple(k): v for k, v in r["shapes"].items()})
            if r["plain_membership_calls"].get("cuda"):
                raise AssertionError(f"scaling_bench: membership's plain version "
                                     f"ran on the card in rank {r['rank']}")
    emit({"phase": "scaling_bench", "seconds": time.perf_counter() - t0,
          "per_dev": per_dev, "steps": steps, "launch_s": seconds,
          "backend": {dp: ranks[0]["backend"] for dp, ranks in by_dp.items()},
          "peak_mem_gb": {dp: [r["peak_mem_gb"] for r in ranks]
                          for dp, ranks in by_dp.items()},
          "membership_launches": launches, "modes": modes})
    for mode, rows in modes.items():
        print(f"S_MODE={mode}", flush=True)
        for row in rows:
            print(row["line"], flush=True)
    return launches, shapes


def run_phases(jobs) -> int:
    from ocn_tpu_torch.data.loaders import synthetic_dataset
    from ocn_tpu_torch.ops import membership, row_gather, segment_sum, window_gather

    seg = {}

    def counted(name, phase, *args, **kw):
        """phase(*args, **kw), its segment-sum launches in this process
        kept as seg[name]: the count set to 0 just before, read just after."""
        segment_sum.segment_sum_raw.launches = 0
        out = phase(*args, **kw)
        seg[name] = segment_sum.segment_sum_raw.launches
        return out

    smi = phase_build()
    kern = phase_kernels()
    phase_reference()
    # early in the process: torch.profiler's trace keeps fewer of a short
    # window's kernels as the process ages (PERF.md section 6, PR 6)
    cli_launches = counted("cli_slice", phase_cli_slice)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ds = synthetic_dataset("collab", seed=0, scale=1.0).reorder_bfs()
    t_data = time.perf_counter() - t0
    m_launches = counted("slice", phase_slice, ds, t_data)
    torch.cuda.empty_cache()
    w_train, w_eval = counted("window_slice", phase_window_slice, ds)
    torch.cuda.empty_cache()
    with captured_segment_sums() as seg_calls:
        b_launches, shapes, bench_losses = counted("bench_slice", phase_bench_slice, ds)
    seg_shapes, seg_shapes_err = phase_segment_sum_shapes(seg_calls)
    # one seed, one result: the main path, arm 1 and cn3, each run twice
    phase_determinism(ds)
    torch.cuda.empty_cache()
    # the multi-device tier: ranks sharing the card, with their reference
    # cases on phase 3's Cora graph
    new = phase_ranks(ds, bench_losses, reference_dataset("Cora"))
    torch.cuda.empty_cache()
    # the new paths, each read with the counts set to 0 just before it
    for name, phase in (("ocnp_slice", phase_ocnp_slice),
                        ("cn6_slice", phase_cn6_slice),
                        ("hoist_slice", phase_hoist_slice)):
        train, evals, phase_shapes = counted(name, phase, ds)
        new[name] = (sum(train["membership_launches_per_step"])
                     + evals["membership_launches_eval"])
        shapes = shapes + phase_shapes
        torch.cuda.empty_cache()
    new["variants_slice"], phase_shapes = counted("variants_slice",
                                                  phase_variants_slice, ds)
    shapes = shapes + phase_shapes
    torch.cuda.empty_cache()
    new["presets_slice"], phase_shapes = counted("presets_slice", phase_presets_slice,
                                                 {"collab": ds})
    shapes = shapes + phase_shapes
    torch.cuda.empty_cache()
    new["family_slice"], phase_shapes = counted("family_slice", phase_family_slice, ds)
    shapes = shapes + phase_shapes
    torch.cuda.empty_cache()
    # the eval instrument's dataset is this one (collab at 1.0, BFS order)
    new["eval_bench"], phase_shapes = counted("eval_bench", phase_eval_bench, ds)
    shapes = shapes + phase_shapes
    del ds
    torch.cuda.empty_cache()
    # the bench program makes its own dataset, as python -m runs it
    bench_launches, bench_window = counted("bench_program", phase_bench_program)
    new["bench_program"] = bench_launches
    new["cli_slice"] = cli_launches
    torch.cuda.empty_cache()
    # while the workers finish the ppa and citation2 datasets
    new["accuracy_slice"], phase_shapes = counted("accuracy_slice", phase_accuracy_slice)
    shapes = shapes + phase_shapes
    torch.cuda.empty_cache()
    new["scaling_bench"], phase_shapes = phase_scaling_bench()
    shapes = shapes + phase_shapes
    # bench.py's ppa and citation2 shapes and the spd preset, each on a
    # dataset of its own, made here
    ds, data = made_dataset(jobs["ppa"])
    train, evals, phase_shapes = counted("ppa_slice", phase_shape_slice, "ppa_slice",
                                         ds, data)
    new["ppa_slice"] = (sum(train["membership_launches_per_step"])
                        + evals["membership_launches_eval"])
    shapes = shapes + phase_shapes
    del ds
    torch.cuda.empty_cache()
    ds, data = made_dataset(jobs["citation2"])
    for name, phase in (("citation2_slice", lambda ds: phase_shape_slice(
            "citation2_slice", ds, data)), ("spd_slice", phase_spd_slice)):
        train, evals, phase_shapes = counted(name, phase, ds)
        new[name] = (sum(train["membership_launches_per_step"])
                     + evals["membership_launches_eval"])
        shapes = shapes + phase_shapes
        torch.cuda.empty_cache()
    del ds
    ds, data = made_dataset(jobs["mrr"])
    new["mrr_bench"], phase_shapes = counted("mrr_bench", phase_mrr_bench, ds, data)
    shapes = shapes + phase_shapes
    del ds
    torch.cuda.empty_cache()
    m_shapes = phase_membership_shapes(shapes)
    g_launches, g_variants = phase_gather_bench()

    m_err, m_timing = kern["membership"]
    w_err, w_timings = kern["window"]
    emit({"kernels": [
        membership_entry(m_err, m_timing, {
            "slice": m_launches,
            "window_slice": w_train["membership"] + w_eval["membership"],
            "bench_slice": b_launches, **new}, m_shapes),
        kernel_entry("window_rows", window_gather, window_gather.REPLACES,
                     w_train["window"] + w_eval["window"] + bench_window,
                     w_err, w_timings[0],
                     launches_train=w_train["window"],
                     launches_eval=w_eval["window"],
                     launches_bench_program=bench_window, k16=w_timings[1]),
        kernel_entry("window_rows:gather_w", window_gather,
                     "scripts/bench_gather.py:148", g_launches["window_rows"],
                     *kern["window_bf16"],
                     gather_bench_ms=g_variants["window_dma"]["ms"]),
        kernel_entry("row_rows", row_gather, row_gather.REPLACES,
                     g_launches["row_rows"], *kern["row"],
                     gather_bench_ms=g_variants["pallas"]["ms"],
                     gather_bench_sorted_ms=g_variants["pallas_srt"]["ms"]),
        kernel_entry("sorted_block_rows", row_gather, row_gather.REPLACES_SORTED,
                     g_launches["sorted_block_rows"], *kern["sorted_block"],
                     gather_bench_ms=g_variants["onehot_mxu"]["ms"]),
        segment_sum_entry(*kern["segment_sum"], seg, seg_shapes, seg_shapes_err),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

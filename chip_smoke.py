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
             runs them back to back, divided by the calls).
3. reference - the slices at a tiny size on the card against the same
             slices on the CPU (plain versions), same initial weights: the plain
             path, the window path with ELL tables and the dual-K split,
             the grouped bfloat16 program, then two steps each of cn7 (also
             with the window table), cn8, cn9, cn1, cn6 (A^3 table, dual-K)
             and hoisted cn5, then of the "ho" stack on ppa (Embedding
             input, path-count cn2, maskinput, ELL tables, dual-K) and on
             citation2 (randint-target negatives, MRR), and of the SDDMM
             two-hop mode (the spd preset's exactly-distance-2 counts):
             losses, Hits or MRR and eval scores compared.
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
             of the step and its ten kernels with the most device time
             (``step_profile``).
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
10. variants_slice - bench.py's program with cn1, cn8 and cn9: one step
             and one evaluate each.
11. presets_slice - each of the 16 README preset keys, presets(dataset,
             predictor): a fresh Trainer, one step and one evaluate (MRR for
             citation2), Cora, Citeseer, Pubmed, ddi and collab at synthetic
             scale 1.0, ppa and citation2 at PRESET_SCALE; every split cut
             to its first EVAL_CUT rows (MRR: PRESET_MRR_CUT sources).
12. ppa_slice - bench.py's ppa shape (bench.py:118-151): the 1-layer "ho"
             gcn at hidden 64 on synthetic ppa (integer features, BFS-
             relabelled) at PPA_SCALE, path-count cn2, batch 16384 in chunks
             of 512, k_small 16 (the split does not engage: no ppa node has
             degree <= 16), frame_group 8, the host A^2 capped at 1024
             (seconds, entries, host and device bytes; its path counts pass
             the col|count packing limit, so the ELL tables stay off, as in
             the JAX package).  Three steps and one evaluate over splits cut
             to EVAL_CUT rows; membership exactly twice per frame group; one
             group re-scored.
13. citation2_slice - bench.py's citation2 shape (bench.py:110-114): the
             3-layer "ho" puregcn at hidden 64 on synthetic citation2 at
             scale 1.0, path-count cn2, randint-target negatives, batch
             32768 in chunks of 2048, A^2 capped at 128.  Three steps, then
             evaluate_mrr over the first MRR_CUT valid and test sources;
             membership exactly twice per frame group; one group re-scored.
14. spd_slice - presets("citation2", "spd") at its own width: the 5-layer
             "ho" gcn at hidden 32, exactly-distance-2 counts in the SDDMM
             mode (no A^2, no ELL table) on the same dataset and MRR cut.
             Membership exactly once per chunk (cn1; the counts' lookup is
             past _COMPARE_LIMIT and takes the binary search); one chunk
             re-scored.
15. membership_shapes - the membership kernel at each (rows, Kq, Ks) that
             phases 6-14 launched: exact against its plain version with unit
             weights, then timed beside its bound.
16. gather_bench - the row-gather instrument ocn_tpu_torch.scripts.bench_gather
             at its full size (the three gather kernels of
             scripts/bench_gather.py on the card); each kernel must launch.

The datasets of phases 12-14 are made in two worker processes while the
card runs phases 1-11; their lines give the workers' seconds and the wait.
Every model phase prints step_ms, losses, train_edges_per_s, eval_s, hits
(or mrr), its membership launches (per step, in eval, by shape) and peak
device memory (train and eval apart where both run); the phases on new
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
import dataclasses
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
# the predictors variants_slice drives on bench.py's program
VARIANTS = ("cn1", "cn8", "cn9")
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
    from ocn_tpu_torch.ops import membership, row_gather, window_gather
    from ocn_tpu_torch.utils import native, toolchain

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        kernels = [pool.submit(m.build)
                   for m in (membership, window_gather, row_gather)]
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
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "checks": m_rows, "membership_timing": m_timing,
          "window_checks": w_rows, "window_timing": w_timings,
          "row_checks": r_rows, "row_timing": r_timing,
          "sorted_block_checks": b_rows, "sorted_block_timing": b_timing,
          "window_bf16_timing": wb_timing})
    return {"membership": (m_err, m_timing), "window": (w_err, w_timings),
            "row": (r_err, r_timing), "sorted_block": (b_err, b_timing),
            "window_bf16": (wb_err, wb_timing)}


def phase_reference():
    """The slices at a tiny size, card against CPU, from the same weights:
    the plain path (no frame cap binds, so no random stream is read), then the
    window-table path with ELL tables and the dual-K split (capped rows ride
    the tables, whose offsets come from NumPy, so again no stream is read),
    then bench.py's grouped bfloat16 program on the tables: frame_group 2
    over a split that the group rounding moves (4 + 3 chunks become 3 + 3)
    and bfloat16 features; three epochs each.  Then, two steps each (one
    epoch), the new predictors on the tables with the dual-K split: cn7
    (also with the window table), cn8, cn9, cn1, cn6 (with its A^3 table),
    and hoisted cn5; their valid-edge scores are compared too.  Then two
    steps each of the "ho" stack: on ppa (Embedding input, path-count cn2,
    maskinput, ELL tables, dual-K), on citation2 (randint-target
    negatives, MRR on 32 sources), and in the SDDMM mode on citation2 (the
    spd preset's exactly-distance-2 counts; no tables, so its caps sit above
    every degree)."""
    from ocn_tpu_torch.config import Config
    from ocn_tpu_torch.data.loaders import synthetic_dataset
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    ds = synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()
    ppa = cut_splits(synthetic_dataset("ppa", seed=0, scale=0.0005), 640, 256
                     ).reorder_bfs()
    c2 = cut_splits(synthetic_dataset("citation2", seed=0, scale=0.00015), 640,
                    32).reorder_bfs()
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
    cases = [(name, cfg, epochs, ds) for name, cfg, epochs in cases]
    ho = dataclasses.replace(tables, encoder_stack="ho", cn2_counts=True,
                             gnnedp=0.3, batch_size=256, linkbatchsize=32,
                             pad_deg=16, pad_deg2=16)
    cases += [
        ("ppa", dataclasses.replace(ho, dataset="ppa", mplayers=1, res=False,
                                    small_frac=0.25, small_frac_neg=0.25), 1, ppa),
        ("citation2", dataclasses.replace(
            ho, dataset="citation2", model="puregcn", mplayers=3,
            neg_mode="randint_target", maskinput=False), 1, c2),
        ("spd", dataclasses.replace(
            ho, dataset="citation2", two_hop_mode="sddmm", exact_two_hop=True,
            neg_mode="randint_target", maskinput=False, pad_deg=64,
            pad_deg2=64, k_small=0), 1, c2)]
    out = {"phase": "reference"}
    for name, cfg, epochs, ds in cases:
        valid = ds.split_edge["valid"]["edge"]
        losses, hits, scores = {}, {}, {}
        for dev in ("cpu", DEVICE):
            tr = Trainer(cfg, ds, device=dev)
            if name == "plain" and (int(tr.g.deg.max()) > cfg.pad_deg
                                    or int(tr.adj2.deg.max()) > cfg.pad_deg2):
                raise AssertionError("reference graph exceeds the frame caps")
            if name in ("window", "cn6", "ppa", "citation2") and not (
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
        np.testing.assert_allclose(losses[DEVICE], losses["cpu"], rtol=1e-4)
        np.testing.assert_allclose(hits[DEVICE], hits["cpu"], rtol=1e-4)
        if scores:
            # scores of order 1 after two Adam steps taken from float32 sums
            # in another order on each side
            np.testing.assert_allclose(scores[DEVICE], scores["cpu"],
                                       rtol=1e-4, atol=1e-4)
        prefix = "" if name == "plain" else f"{name}_"
        metric = "mrr" if cfg.dataset == "citation2" else "hits50"
        out.update({f"{prefix}loss_cpu": losses["cpu"],
                    f"{prefix}loss_cuda": losses[DEVICE],
                    f"{prefix}{metric}_cpu": hits["cpu"],
                    f"{prefix}{metric}_cuda": hits[DEVICE]})
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
    with torch.no_grad():
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
            + evals["membership_launches_eval"]), shapes


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
    step and by (rows, Kq, Ks); returns (state, record, shapes)."""
    from ocn_tpu_torch.ops.membership import membership_counts

    torch.cuda.reset_peak_memory_stats()
    membership_counts.shapes.clear()
    step_ms, losses, per_step = [], [], []
    for idx in batches:
        membership_counts.launches = 0
        state, ms, loss = run_steps(tr, state, pos, neg, [idx], gen)
        per_step.append(membership_counts.launches)
        step_ms += ms
        losses += loss
    shapes = collections.Counter(membership_counts.shapes)
    return state, {
        "step_ms": step_ms,
        "train_edges_per_s": [2e3 * tr.cfg.batch_size / ms for ms in step_ms],
        "losses": losses, "membership_launches_per_step": per_step,
        "membership_shapes_train": shape_list(shapes),
        "peak_mem_train_gb": torch.cuda.max_memory_allocated() / 1e9}, shapes


def timed_eval(tr, state):
    """One evaluate (Trainer.evaluate_mrr for citation2), timed, its
    membership launches counted and its peak device memory apart from the
    training's; returns (record, shapes)."""
    from ocn_tpu_torch.ops.membership import membership_counts

    torch.cuda.reset_peak_memory_stats()
    membership_counts.launches = 0
    membership_counts.shapes.clear()
    te = time.perf_counter()
    results = evaluate(tr, state)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - te
    check_hits(results)
    shapes = collections.Counter(membership_counts.shapes)
    return {"eval_s": t_eval,
            ("mrr" if tr.cfg.dataset == "citation2" else "hits"): results,
            "membership_launches_eval": membership_counts.launches,
            "membership_shapes_eval": shape_list(shapes),
            "peak_mem_eval_gb": torch.cuda.max_memory_allocated() / 1e9}, shapes


def rescore(tr, state, pos, neg, idx, cases, per_group):
    """Score link groups of one prepared batch in eval mode twice, with
    membership on the kernel and routed to its plain version, and hold the
    scores together (rtol/atol 1e-5).  ``cases(pe, ne, chunk)`` lists the
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
    with torch.no_grad():
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
    """bench.py's program with OCN_BENCH_PREDICTOR = cn1, cn8 and cn9: one
    step and one evaluate each (cn1 and cn9 carry two (n_nodes, hidden)
    one-hot weights)."""
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    out, launches, shapes = {}, 0, collections.Counter()
    pos = neg = batches = None
    for name in VARIANTS:
        cfg = slice_config(**{**BENCH_PATH, "predictor": name, **overrides})
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
    emit({"phase": "variants_slice", "seconds": time.perf_counter() - t0, **out})
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
    # the ppa and citation2 datasets take minutes of NumPy on the host: two
    # worker processes make them while the card runs phases 1-11
    with ProcessPoolExecutor(max_workers=2,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {"ppa": pool.submit(new_dataset, "ppa", PPA_SCALE, EVAL_CUT,
                                   EVAL_CUT),
                "citation2": pool.submit(new_dataset, "citation2", 1.0,
                                         TRAIN_CUT, MRR_CUT)}
        return run_phases(jobs)


def made_dataset(job):
    """A worker's (dataset, record), with the seconds the card phases then
    waited for it."""
    t0 = time.perf_counter()
    ds, data = job.result()
    return ds, {**data, "waited_s": time.perf_counter() - t0}


def run_phases(jobs) -> int:
    from ocn_tpu_torch.data.loaders import synthetic_dataset
    from ocn_tpu_torch.ops import membership, row_gather, window_gather

    smi = phase_build()
    kern = phase_kernels()
    phase_reference()
    t0 = time.perf_counter()
    ds = synthetic_dataset("collab", seed=0, scale=1.0).reorder_bfs()
    t_data = time.perf_counter() - t0
    m_launches = phase_slice(ds, t_data)
    torch.cuda.empty_cache()
    w_train, w_eval = phase_window_slice(ds)
    torch.cuda.empty_cache()
    b_launches, shapes = phase_bench_slice(ds)
    torch.cuda.empty_cache()
    # the new paths, each read with the counts set to 0 just before it
    new = {}
    for name, phase in (("ocnp_slice", phase_ocnp_slice),
                        ("cn6_slice", phase_cn6_slice),
                        ("hoist_slice", phase_hoist_slice)):
        train, evals, phase_shapes = phase(ds)
        new[name] = (sum(train["membership_launches_per_step"])
                     + evals["membership_launches_eval"])
        shapes = shapes + phase_shapes
        torch.cuda.empty_cache()
    new["variants_slice"], phase_shapes = phase_variants_slice(ds)
    shapes = shapes + phase_shapes
    torch.cuda.empty_cache()
    new["presets_slice"], phase_shapes = phase_presets_slice({"collab": ds})
    shapes = shapes + phase_shapes
    del ds
    torch.cuda.empty_cache()
    # bench.py's ppa and citation2 shapes and the spd preset, each on a
    # dataset of its own, made here
    ds, data = made_dataset(jobs["ppa"])
    train, evals, phase_shapes = phase_shape_slice("ppa_slice", ds, data)
    new["ppa_slice"] = (sum(train["membership_launches_per_step"])
                        + evals["membership_launches_eval"])
    shapes = shapes + phase_shapes
    del ds
    torch.cuda.empty_cache()
    ds, data = made_dataset(jobs["citation2"])
    for name, phase in (("citation2_slice", lambda ds: phase_shape_slice(
            "citation2_slice", ds, data)), ("spd_slice", phase_spd_slice)):
        train, evals, phase_shapes = phase(ds)
        new[name] = (sum(train["membership_launches_per_step"])
                     + evals["membership_launches_eval"])
        shapes = shapes + phase_shapes
        torch.cuda.empty_cache()
    del ds
    m_shapes = phase_membership_shapes(shapes)
    g_launches, g_variants = phase_gather_bench()

    m_err, m_timing = kern["membership"]
    w_err, w_timings = kern["window"]
    emit({"kernels": [
        kernel_entry("membership_counts", membership, membership.REPLACES,
                     m_launches, m_err, m_timing,
                     launches_window_slice=w_train["membership"] + w_eval["membership"],
                     launches_bench_slice=b_launches,
                     **{f"launches_{name}": n for name, n in new.items()},
                     model_shapes=m_shapes),
        kernel_entry("window_rows", window_gather, window_gather.REPLACES,
                     w_train["window"] + w_eval["window"], w_err, w_timings[0],
                     launches_train=w_train["window"],
                     launches_eval=w_eval["window"], k16=w_timings[1]),
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
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

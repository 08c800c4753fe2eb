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
             ``device_ms`` the kernel's own time on the card (torch.profiler,
             device time summed by kernel name over 50 calls, divided by the
             launches).
3. reference - the slice at a tiny size on the card against the same slice
             on the CPU (plain versions), same initial weights: once as
             PR 1's path, once with ELL tables, the dual-K split and the
             window table.
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
7. membership_shapes - the membership kernel timed at each (rows, Kq, Ks)
             that bench_slice launched.
8. gather_bench - the row-gather instrument ocn_tpu_torch.scripts.bench_gather
             at its full size (the three gather kernels of
             scripts/bench_gather.py on the card); each kernel must launch.

Phase 2 also holds the row gather, the sorted-block gather and the window
gather at bfloat16 against their plain versions, exactly, at the
instrument's shapes and at ragged ones.

The line before the last is {"kernels": [...]}, then the nvidia-smi line,
and the last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or outside the repository, it exits nonzero and prints no result.
"""
import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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


def device_ms(fn, pattern: str) -> dict:
    """The kernel's own time on the card: torch.profiler's device time of
    the kernels named like ``pattern`` over 50 calls, per launch, and the
    launches the trace holds (it can miss the first few; more than 50
    would mean a call launched the kernel twice)."""
    from ocn_tpu_torch.utils import profiling

    ms, launches = profiling.kernel_device_ms(fn, pattern)
    if launches > 50:
        raise AssertionError(f"{pattern}: {launches} launches in 50 calls")
    return {"device_ms": ms, "device_launches": launches}


MEMBERSHIP_KERNEL = r"membership_kernel"
WINDOW_KERNEL = r"window_rows_kernel"


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
            **device_ms(lambda: membership_counts(q, ids, w), MEMBERSHIP_KERNEL),
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
    # a call is one device kernel: no start arithmetic around it
    activities = profiling.profile_calls(lambda: W.window_rows(y, pos0, 16), 1)
    if len(activities) != 1:
        raise AssertionError(f"window_rows: {len(activities)} device activities "
                             f"in one call: {[a[0][:60] for a in activities]}")
    timings[0]["device_activities_per_call"] = len(activities)
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
            **device_ms(lambda: W.window_rows(y, pos0, k), WINDOW_KERNEL),
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
              **device_ms(lambda: RG.row_rows(x, idx), r"\brow_rows_kernel\b"),
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
              **device_ms(lambda: RG.sorted_block_rows(x, ids, bases, ts, w),
                          r"sorted_block_rows_kernel"),
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
    """The slice at a tiny size, card against CPU, from the same weights:
    PR 1's path (no frame cap binds, so no random stream is read), then the
    window-table path with ELL tables and the dual-K split (capped rows ride
    the tables, whose offsets come from NumPy, so again no stream is read),
    then bench.py's grouped bfloat16 program on the tables: frame_group 2
    over a split that the group rounding moves (4 + 3 chunks become 3 + 3)
    and bfloat16 features."""
    from ocn_tpu_torch.config import Config
    from ocn_tpu_torch.data.loaders import synthetic_dataset
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    ds = synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()
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
    out = {"phase": "reference"}
    for name, cfg in (("plain", base), ("window", window), ("grouped", grouped)):
        losses, hits = {}, {}
        for dev in ("cpu", DEVICE):
            tr = Trainer(cfg, ds, device=dev)
            if name == "plain" and (int(tr.g.deg.max()) > cfg.pad_deg
                                    or int(tr.adj2.deg.max()) > cfg.pad_deg2):
                raise AssertionError("reference graph exceeds the frame caps")
            if name == "window" and not (tr._use_ell and tr._split):
                raise AssertionError("window reference: tables or split off")
            if name == "grouped" and (tr._split != (3, 3)
                                      or tr.x.dtype != torch.bfloat16):
                raise AssertionError(f"grouped reference: split {tr._split}, "
                                     f"features {tr.x.dtype}")
            state = tr.init_state(0)
            rng = np.random.default_rng(0)
            W.window_rows.launches = 0
            losses[dev] = [tr.train_epoch(state, rng, ep)[1] for ep in (1, 2, 3)]
            hits[dev] = tr.evaluate(state)["Hits@50"]
            if name == "window" and dev != "cpu" and W.window_rows.launches == 0:
                raise AssertionError("window reference: the kernel never ran")
        np.testing.assert_allclose(losses[DEVICE], losses["cpu"], rtol=1e-4)
        np.testing.assert_allclose(hits[DEVICE], hits["cpu"], rtol=1e-4)
        prefix = "" if name == "plain" else f"{name}_"
        out.update({f"{prefix}loss_cpu": losses["cpu"],
                    f"{prefix}loss_cuda": losses[DEVICE],
                    f"{prefix}hits50_cpu": hits["cpu"],
                    f"{prefix}hits50_cuda": hits[DEVICE]})
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
    seed 0 as bench.py draws them."""
    from ocn_tpu_torch.sparse import build as B

    rng = np.random.default_rng(0)
    pos = tr.train_edges
    e = pos.shape[1]
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
    for key, vals in results.items():
        if not all(0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f"{key} out of range: {vals}")


def phase_slice(ds, t_data, **overrides):
    """PR 1's path at full width.  ``overrides`` of slice_config shrink
    this phase and the next, and DEVICE moves them, for the rehearsal on
    the CPU in tests/test_torch_chip_smoke.py."""
    import ocn_tpu_torch.ops.frame as frame
    from ocn_tpu_torch.ops import window_gather as W
    from ocn_tpu_torch.ops.membership import (
        membership_counts, membership_counts_plain)
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
    c = tr._chunk()
    pe, ne, mp, _, _ = tr.prepare_batch(pos[:, batches[-1]], neg[:, batches[-1]],
                                        batches[-1])
    g = tr.g.mask_edges(mp)
    with torch.no_grad():
        h = tr.encode(state)
        valid = torch.ones(c, device=DEVICE)

        def chunk_scores():
            state.predictor.eval()
            ps = tr._score_chunk(state, h, g, pe[:, :c], valid, None, False,
                                 tr.adj2, corr=valid)
            ns = tr._score_chunk(state, h, g, ne[:, :c], valid, None, False,
                                 tr.adj2)
            return ps, ns, tr._loss(ps, ns).item()

        kp, kn, k_loss = chunk_scores()
        frame.membership_counts = membership_counts_plain
        try:
            pp, pn, p_loss = chunk_scores()
        finally:
            frame.membership_counts = membership_counts
    score_err = max((kp - pp).abs().max().item(), (kn - pn).abs().max().item())
    torch.testing.assert_close(kp, pp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kn, pn, rtol=1e-5, atol=1e-5)
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
          "hits": results, "chunk_loss_kernel": k_loss,
          "chunk_loss_plain": p_loss, "chunk_score_max_abs_err": score_err,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def phase_window_slice(ds, **overrides):
    """The window-table path at full width."""
    import ocn_tpu_torch.ops.frame as frame
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

    # membership launches by query width: Kq = k_small in the small body
    by_kq = collections.Counter()
    real_membership = frame.membership_counts

    def tally(q, *args):
        by_kq[str(q.shape[-1])] += 1
        return real_membership(q, *args)

    pos, neg, batches = step_batches(tr, ds)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    frame.membership_counts = tally
    try:
        membership_counts.launches = 0
        W.window_rows.launches = 0
        state, step_ms, losses = run_steps(tr, state, pos, neg, batches, gen)
        train = {"window": W.window_rows.launches,
                 "membership": membership_counts.launches,
                 "membership_by_kq": dict(by_kq)}
        peak_train = torch.cuda.max_memory_allocated() / 1e9
        by_kq.clear()
        membership_counts.launches = 0
        W.window_rows.launches = 0
        te = time.perf_counter()
        results = tr.evaluate(state)
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - te
        evals = {"window": W.window_rows.launches,
                 "membership": membership_counts.launches,
                 "membership_by_kq": dict(by_kq)}
    finally:
        frame.membership_counts = real_membership
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
    nsp, nsn = split
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
    import ocn_tpu_torch.ops.frame as frame
    from ocn_tpu_torch.ops.membership import (
        membership_counts, membership_counts_plain)
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
    c = tr._chunk()
    groups = frame_groups(cfg, tr._split, c)

    # a fourth batch for the profiled step, after the checks
    pos, neg, batches = step_batches(tr, ds, nsteps=4)
    batches, profiled = batches[:3], batches[3]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = [], [], []
    membership_counts.shapes.clear()
    for idx in batches:
        membership_counts.launches = 0
        state, ms, loss = run_steps(tr, state, pos, neg, [idx], gen)
        per_step.append(membership_counts.launches)
        step_ms += ms
        losses += loss
    shapes = dict(membership_counts.shapes)
    # one cn_frames call per group: cn1 and cn2 membership, at group rows
    if per_step != [2 * groups] * len(batches):
        raise AssertionError(f"membership launches per step {per_step}; "
                             f"expected {2 * groups} ({groups} groups)")
    peak_train = torch.cuda.max_memory_allocated() / 1e9
    membership_counts.launches = 0
    te = time.perf_counter()
    results = tr.evaluate(state)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - te
    eval_launches = membership_counts.launches
    check_hits(results)

    # the last step's first small-body group, eval mode, scored with the
    # kernel and with membership routed to its plain version
    grp = cfg.frame_group
    pe, ne, mp, _, _ = tr.prepare_batch(pos[:, batches[-1]], neg[:, batches[-1]],
                                        batches[-1])
    g = tr._masked_graph(mp)
    adj2 = tr._local_adj2(mp)
    with torch.no_grad():
        h = tr.encode(state)
        valid = torch.ones(grp * c, dtype=tr.dtype, device=DEVICE)

        def group_scores():
            state.predictor.eval()
            return tr._score_chunk(state, h, g, pe[:, :grp * c], valid, None,
                                   False, adj2, corr=valid, k=cfg.k_small,
                                   grp=grp)

        before = membership_counts.launches
        ks = group_scores()
        if membership_counts.launches != before + 2:
            raise AssertionError("the re-scored group did not launch membership twice")
        frame.membership_counts = membership_counts_plain
        try:
            ps = group_scores()
        finally:
            frame.membership_counts = membership_counts
    score_err = (ks - ps).abs().max().item()
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-5)
    step_profile = profile_step(tr, state, pos, neg, profiled, gen)
    emit({"phase": "bench_slice", "seconds": time.perf_counter() - t0,
          "trainer_init_s": t_trainer, "ell_refresh_s": refresh_s,
          "split": list(tr._split), "frame_group": grp,
          "groups_per_step": groups, "x_dtype": str(tr.x.dtype),
          "h_dtype": str(h_dtype), "step_ms": step_ms,
          "train_edges_per_s": [2e3 * cfg.batch_size / ms for ms in step_ms],
          "losses": losses, "membership_launches_per_step": per_step,
          "membership_shapes": [[*shape, n] for shape, n in shapes.items()],
          "membership_launches_eval": eval_launches, "eval_s": t_eval,
          "hits": results, "group_score_max_abs_err": score_err,
          "peak_mem_train_gb": peak_train,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "step_profile": step_profile})
    return sum(per_step) + eval_launches, shapes


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
    """membership_counts timed at each (rows, Kq, Ks) that bench_slice
    launched in its training steps."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    timings = [membership_timing(gen, *shape) for shape in sorted(shapes)]
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
    b_launches, b_shapes = phase_bench_slice(ds)
    del ds
    torch.cuda.empty_cache()
    m_grouped = phase_membership_shapes(b_shapes)
    g_launches, g_variants = phase_gather_bench()

    m_err, m_timing = kern["membership"]
    w_err, w_timings = kern["window"]
    emit({"kernels": [
        kernel_entry("membership_counts", membership, membership.REPLACES,
                     m_launches, m_err, m_timing,
                     launches_window_slice=w_train["membership"] + w_eval["membership"],
                     launches_bench_slice=b_launches,
                     bench_slice_shapes=m_grouped),
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

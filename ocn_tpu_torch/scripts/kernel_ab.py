"""Time the membership, window-gather and segment-sum kernels of one
checkout of the port on one card, so that two checkouts (a commit and its
parent) can be compared.

    python ocn_tpu_torch/scripts/kernel_ab.py --root DIR [--only segment_sum]

imports ``ocn_tpu_torch`` from the checkout at DIR (its wrappers and its
kernels, built into DIR's own ``ocn_tpu_torch/_build/``) and times it with
this checkout's ``utils/profiling.py``, on the same inputs whatever DIR is
(fixed seeds), at the main path's shapes:

* ``membership_counts`` at (rows, Kq, Ks) = (4096, 64, 64), the chunk of the
  plain and window paths, and (32768, 16, 64), (32768, 64, 64), the frame
  groups of the bench program;
* ``window_rows`` at (B, K) = (4096, 64) and (4096, 16) on the float32
  table of the full-width slice (1,324,714 x 256), with int64 starts as
  ops/frame.py passes them (column 0 of the (B, K) positions, a strided
  view) and at (4096, 64) with contiguous int32 starts as chip_smoke.py
  times it; and (4096, 64) on the instrument's bfloat16 table;
* ``segment_sum_raw`` at the main path's four shapes (entries, segments,
  H): the graph's row sums (1,324,714, 235,868, 1; values, no idx), the
  frame-matmul dx at (65,536, 235,868, 256) (4,096 targets x 16 lanes of
  a random graph, lane k of a target with fewer than k + 1 neighbours on
  the sentinel node n - 1 as ops/frame.py puts it, sorted by node), the
  encoder SpMM (1,324,714, 235,868, 256; rows sorted, int32 columns,
  float32 values) and the column sums at (65,536, 65,536, 3) (the same
  frame's ids ranked, three planes read through their strides, trailing
  empty ranks).  Here ``device_ms`` is the card's time a call (CUDA events
  around 50 calls queued behind a spin, utils/profiling.py
  queued_device_ms) and ``device_ms_per_call`` sums every kernel a call
  launches.

For each: ``ms``, the wrapper's per-call time (CUDA events over 200 calls);
``kernel_ms``, the device time of the named kernel alone per launch
(torch.profiler over 50 calls); ``device_ms_per_call``, the device time of
every activity a call runs (kernels, copies, fills), summed over those 50
calls and divided by 50; and ``activities_per_call``.  Each kernel is first
held against its plain version (the window gather exactly, membership
within 1e-6).  One JSON line is printed per checkout, with the card's name
and power limit as nvidia-smi gives them.

Run each checkout in a process of its own, in one call of the card, in the
order A, B, B, A, so that drift of the card's clocks shows.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

MEMBERSHIP_SHAPES = ((4096, 64, 64), (32768, 16, 64), (32768, 64, 64))
# (label, table rows, dtype name, B, K, starts)
WINDOW_CASES = (
    ("f32 K=64 int64 strided", 1_324_714, "float32", 4096, 64, "int64"),
    ("f32 K=64 int32", 1_324_714, "float32", 4096, 64, "int32"),
    ("f32 K=16 int64 strided", 1_324_714, "float32", 4096, 16, "int64"),
    ("bf16 K=64 int32", 1_320_618, "bfloat16", 4096, 64, "int32"),
)
ITERS = 50
KERNELS = ("membership", "window", "segment_sum")
N_NODES, NNZ = 235_868, 1_324_714


def load_profiling():
    """This checkout's utils/profiling.py, whatever package DIR holds."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_profiling", os.path.join(here, "utils", "profiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(torch, profiling, fn, pattern):
    """Per-call ms (CUDA events), and the device time of one call: the
    kernel named like ``pattern`` per launch, every activity per call."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 200
    acts = profiling.profile_calls(fn, ITERS)
    hits = [t1 - t0 for name, t0, t1 in acts if re.search(pattern, name)]
    if not hits:
        raise RuntimeError(f"the profiler lists no kernel matching {pattern!r}")
    return {"ms": ms, "kernel_ms": sum(hits) / len(hits) / 1e3,
            "kernel_launches": len(hits),
            "device_ms_per_call": sum(t1 - t0 for _, t0, t1 in acts) / ITERS / 1e3,
            "activities_per_call": len(acts) / ITERS,
            "activity_names": sorted({name[:60] for name, _, _ in acts}),
            "ms_by_kernel": by_kernel(acts)}


def by_kernel(acts):
    """Device ms a launch of each kernel (its first name after a
    namespace, else its first 40 characters)."""
    ms, count = {}, {}
    for name, t0, t1 in acts:
        found = re.search(r"::(\w+)", name)
        key = found.group(1) if found else name[:40]
        ms[key] = ms.get(key, 0.0) + (t1 - t0) / 1e3
        count[key] = count.get(key, 0) + 1
    return {key: ms[key] / count[key] for key in ms}


def membership(torch, profiling):
    from ocn_tpu_torch.ops import membership as M

    out = []
    for rows, kq, ks in MEMBERSHIP_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(rows + kq + ks)
        q = torch.randint(0, 235868, (rows, kq), generator=gen, device="cuda",
                          dtype=torch.int32)
        ids = torch.randint(0, 235868, (rows, ks), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids = torch.sort(ids, dim=-1).values.contiguous()
        ids[:, :8] = q[:, :8]  # some hits in every row
        w = torch.rand((rows, ks), generator=gen, device="cuda")
        got = M.membership_counts(q, ids, w)
        torch.testing.assert_close(got, M.membership_counts_plain(q, ids, w),
                                   rtol=1e-6, atol=1e-6)
        out.append({"shape": [rows, kq, ks],
                    **timed(torch, profiling,
                            lambda: M.membership_counts(q, ids, w),
                            r"membership_kernel")})
    return out


def window(torch, profiling):
    from ocn_tpu_torch.ops import window_gather as W

    out, tables = [], {}
    for label, e, dtype, b, k, starts in WINDOW_CASES:
        if (e, dtype) not in tables:
            tables.clear()
            gen = torch.Generator(device="cuda").manual_seed(e)
            tables[(e, dtype)] = torch.randn(
                (e, 256), generator=gen, device="cuda").to(getattr(torch, dtype))
        y = tables[(e, dtype)]
        gen = torch.Generator(device="cuda").manual_seed(b + k)
        if starts == "int64":
            pos = (torch.randint(0, e - k + 1, (b, 1), generator=gen,
                                 device="cuda") + torch.arange(k, device="cuda"))
            pos0 = pos[:, 0]
        else:
            pos0 = torch.randint(0, e - k + 1, (b,), generator=gen,
                                 device="cuda", dtype=torch.int32)
        rows, off = W.window_rows(y, pos0, k)
        want, want_off = W.window_rows_plain(y, pos0, k)
        if not (torch.equal(rows, want) and torch.equal(off, want_off)):
            raise AssertionError(f"window_rows {label}: differs from plain")
        out.append({"case": label, "shape": [b, k + W.SLACK, 256],
                    **timed(torch, profiling, lambda: W.window_rows(y, pos0, k),
                            r"window_rows")})
    return out


def frame_ids(np, seed, rows=4096, lanes=16):
    """(rows * lanes,) node ids of a frame: each target's neighbours (a
    geometric degree of mean 5.6, the collab stand-in's) in its first lanes,
    the sentinel n - 1 in the rest."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.geometric(1 / 5.6, size=rows), lanes)
    ids = rng.integers(0, N_NODES - 1, size=(rows, lanes))
    ids[np.arange(lanes)[None, :] >= deg[:, None]] = N_NODES - 1
    return ids.reshape(-1)


def segment_sum_inputs(torch, np, SS):
    """(label, (src, off, idx, scale)) of the four shapes, from fixed seeds."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    row = torch.sort(torch.randint(0, N_NODES, (NNZ,), generator=gen, device="cuda")).values
    graph_off = SS.sorted_offsets(row, N_NODES)
    val = torch.rand(NNZ, generator=gen, device="cuda")
    col = torch.randint(0, N_NODES, (NNZ,), generator=gen, device="cuda", dtype=torch.int32)
    x = torch.randn((N_NODES, 256), generator=gen, device="cuda")
    ids = torch.as_tensor(frame_ids(np, 1), device="cuda")
    perm, node_off = SS.sort_segments(ids, N_NODES)
    coef = torch.randn((ids.numel(), 256), generator=gen, device="cuda")
    # ranks of the distinct ids in sorted order: M + 1 offsets, every one
    # past the last rank equal to M
    srt = ids[perm]
    rank = torch.cumsum(torch.cat([srt.new_zeros(1), (srt[1:] != srt[:-1]).long()]), 0)
    rank_off = SS.sorted_offsets(rank, ids.numel())
    planes = torch.randn((3, ids.numel()), generator=gen, device="cuda")
    return [("row sums", (val, graph_off, None, None)),
            ("frame dx", (coef, node_off, perm, None)),
            ("SpMM", (x, graph_off, col, val)),
            ("column sums", (planes.T, rank_off, perm, None))]


def segment_sum(torch, profiling):
    import numpy as np

    from ocn_tpu_torch.ops import segment_sum as SS

    out = []
    for label, (src, off, idx, scale) in segment_sum_inputs(torch, np, SS):
        got = SS.segment_sum_raw(src, off, idx, scale)
        sc = None if scale is None else scale.double()
        want = SS.segment_sum_plain(src.double(), off, idx, sc)
        mag = SS.segment_sum_plain(src.double().abs(), off, idx,
                                   None if sc is None else sc.abs())
        if not bool(((got.double() - want).abs() <= 1e-5 * mag + 1e-30).all()):
            raise AssertionError(f"segment_sum {label}: differs from plain")
        q = idx.numel() if idx is not None else src.shape[0]
        fn = lambda: SS.segment_sum_raw(src, off, idx, scale)  # noqa: E731
        out.append({"case": label,
                    "shape": [q, off.numel() - 1, src.shape[1] if src.dim() == 2 else 1],
                    "device_ms": profiling.queued_device_ms(fn),
                    **timed(torch, profiling, fn, r"seg_")})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=list(KERNELS),
                    help="the kernels to time (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import ocn_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(ocn_tpu_torch.__file__))) != root:
        raise RuntimeError(f"imported {ocn_tpu_torch.__file__}, not the one in {root}")
    profiling = load_profiling()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    runs = {"membership": membership, "window": window, "segment_sum": segment_sum}
    print(json.dumps({"root": args.root, "nvidia_smi": smi,
                      **{k: runs[k](torch, profiling) for k in args.only}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

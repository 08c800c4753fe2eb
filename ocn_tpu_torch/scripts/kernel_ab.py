"""Time the membership and window-gather kernels of one checkout of the
port on one card, so that two checkouts (a commit and its parent) can be
compared.

    python ocn_tpu_torch/scripts/kernel_ab.py --root DIR

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
  times it; and (4096, 64) on the instrument's bfloat16 table.

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
            "activity_names": sorted({name[:60] for name, _, _ in acts})}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="root of the checkout whose kernels are timed")
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
    print(json.dumps({"root": args.root, "nvidia_smi": smi,
                      "membership": membership(torch, profiling),
                      "window": window(torch, profiling)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

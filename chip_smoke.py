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
             it is a copy), then timed with CUDA events beside its bound
             and, where one PyTorch call computes the same function, that
             call.
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


def bound(nbytes: int, ops: int) -> dict:
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def phase_build():
    from ocn_tpu_torch.ops import membership, window_gather
    from ocn_tpu_torch.utils import native, toolchain

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        kernels = [pool.submit(membership.build), pool.submit(window_gather.build)]
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
    # chunk, cn1 at a k2_dst of 16, the eval batch, a ragged B with many
    # duplicate ids, and (B, R, K) leading dims
    cases = [
        ((4096,), 64, 64, 235868, False),
        ((4096,), 64, 16, 235868, False),
        ((65536,), 64, 64, 235868, False),
        ((300,), 16, 32, 77, True),
        ((512, 8), 64, 16, 5000, True),
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

    b, kq, ks = 4096, 64, 64
    q, ids, w = membership_inputs(gen, (b,), kq, ks, 235868, False)
    timing = {"shape": [b, kq, ks],
              "ms": cuda_time_ms(lambda: membership_counts(q, ids, w)),
              "plain_ms": cuda_time_ms(lambda: membership_counts_plain(q, ids, w)),
              # one compare and one add per (b, k, s)
              **bound(b * (4 * kq + 8 * ks) + 4 * b * kq, 2 * b * kq * ks)}
    return rows, max_err, timing


def window_checks(gen):
    from ocn_tpu_torch.ops import window_gather as W

    # the hoisted table of the full-width slice: one row per adjacency entry
    # (GATHER_PAD tail included), hidden 256, float32
    e, h = 1_324_714, 256
    y = torch.randn((e, h), generator=gen, device="cuda")
    rows, max_err = [], 0.0

    def check(y, b, k, label):
        nonlocal max_err
        e = y.shape[0]
        pos0 = torch.randint(0, max(e - k, 0) + 1, (b,), generator=gen,
                             device="cuda", dtype=torch.int32)
        pos0[0] = 0
        pos0[-1] = max(e - k, 0)  # the last window's aligned start clamps
        got, goff = W.window_rows(y, pos0, k)
        torch.cuda.synchronize()
        want, woff = W.window_rows_plain(y, pos0, k)
        err = (got.float() - want.float()).abs().max().item()
        # a copy: exact
        if not (torch.equal(got, want) and torch.equal(goff, woff)):
            raise AssertionError(f"window_rows {label}: differs from plain ({err})")
        max_err = max(max_err, err)
        rows.append({"case": label, "shape": [b, k + W.SLACK, y.shape[1]],
                     "dtype": str(y.dtype), "max_abs_err": err})

    # the train chunk's big and small bodies, and the eval batch
    for b, k in ((4096, 64), (4096, 16), (65536, 64)):
        check(y, b, k, f"B={b} K={k}")
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

    timings = []
    for b, k in ((4096, 64), (4096, 16)):
        pos0 = torch.randint(0, e - k + 1, (b,), generator=gen, device="cuda",
                             dtype=torch.int32)
        j = k + W.SLACK
        p0a, _ = W.aligned_starts(pos0, e, k)
        # the same rows as one index_select, indices built outside the timing
        idx = torch.clamp(p0a.long()[:, None]
                          + torch.arange(j, device="cuda"), max=e - 1).reshape(-1)
        itemsize = y.element_size()
        timings.append({
            "shape": [b, j, h],
            "ms": cuda_time_ms(lambda: W.window_rows(y, pos0, k)),
            "plain_ms": cuda_time_ms(lambda: W.window_rows_plain(y, pos0, k)),
            "library_ms": cuda_time_ms(lambda: torch.index_select(y, 0, idx)),
            # read each window's rows and the starts, write the rows and the
            # offsets; no arithmetic
            **bound(2 * b * j * h * itemsize + 4 * b + 4 * b, 0)})
    return rows, max_err, timings


def phase_kernels():
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    m_rows, m_err, m_timing = membership_checks(gen)
    w_rows, w_err, w_timings = window_checks(gen)
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "checks": m_rows, "membership_timing": m_timing,
          "window_checks": w_rows, "window_timing": w_timings})
    return {"membership": (m_err, m_timing), "window": (w_err, w_timings)}


def phase_reference():
    """The slice at a tiny size, card against CPU, from the same weights:
    PR 1's path (no frame cap binds, so no random stream is read), then the
    window-table path with ELL tables and the dual-K split (capped rows ride
    the tables, whose offsets come from NumPy, so again no stream is read)."""
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
    out = {"phase": "reference"}
    for name, cfg in (("plain", base), ("window", window)):
        losses, hits = {}, {}
        for dev in ("cpu", DEVICE):
            tr = Trainer(cfg, ds, device=dev)
            if name == "plain" and (int(tr.g.deg.max()) > cfg.pad_deg
                                    or int(tr.adj2.deg.max()) > cfg.pad_deg2):
                raise AssertionError("reference graph exceeds the frame caps")
            if name == "window" and not (tr._use_ell and tr._split):
                raise AssertionError("window reference: tables or split off")
            state = tr.init_state(0)
            rng = np.random.default_rng(0)
            W.window_rows.launches = 0
            losses[dev] = [tr.train_epoch(state, rng, ep)[1] for ep in (1, 2, 3)]
            hits[dev] = tr.evaluate(state)["Hits@50"]
            if name == "window" and dev != "cpu" and W.window_rows.launches == 0:
                raise AssertionError("window reference: the kernel never ran")
        np.testing.assert_allclose(losses[DEVICE], losses["cpu"], rtol=1e-4)
        np.testing.assert_allclose(hits[DEVICE], hits["cpu"], rtol=1e-4)
        prefix = "" if name == "plain" else "window_"
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
    from ocn_tpu_torch.ops import membership, window_gather

    smi = phase_build()
    kern = phase_kernels()
    phase_reference()
    t0 = time.perf_counter()
    ds = synthetic_dataset("collab", seed=0, scale=1.0).reorder_bfs()
    t_data = time.perf_counter() - t0
    m_launches = phase_slice(ds, t_data)
    torch.cuda.empty_cache()
    w_train, w_eval = phase_window_slice(ds)

    m_err, m_timing = kern["membership"]
    w_err, w_timings = kern["window"]
    emit({"kernels": [{
        "name": "membership_counts", "route": "cuda",
        "source": membership.SOURCE, "replaces": membership.REPLACES,
        "launches": m_launches,
        "launches_window_slice": w_train["membership"] + w_eval["membership"],
        "max_abs_err": m_err, "ms": m_timing["ms"],
        "plain_ms": m_timing["plain_ms"], "bound_ms": m_timing["bound_ms"],
        "bound_by": m_timing["bound_by"], "library_ms": None,
    }, {
        "name": "window_rows", "route": "cuda",
        "source": window_gather.SOURCE, "replaces": window_gather.REPLACES,
        "launches": w_train["window"] + w_eval["window"],
        "launches_train": w_train["window"], "launches_eval": w_eval["window"],
        "max_abs_err": w_err, "ms": w_timings[0]["ms"],
        "plain_ms": w_timings[0]["plain_ms"],
        "bound_ms": w_timings[0]["bound_ms"],
        "bound_by": w_timings[0]["bound_by"],
        "library_ms": w_timings[0]["library_ms"],
        "shape": w_timings[0]["shape"], "k16": w_timings[1],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

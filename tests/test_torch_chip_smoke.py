"""chip_smoke.py's model phases rehearsed on the CPU at a tiny size.

The script itself needs a card; here its ``DEVICE`` is the CPU, the CUDA
synchronisation and memory calls are no-ops, and the kernel wrappers are
wrapped to count their (plain-version) calls, so the phases' own checks
(launch counts, finite losses, Hits ranges, kernel-against-plain chunk
scores, feature and hidden dtypes) run as they do on the card.  The step
profile runs with host tracing only: a CPU run has no device numbers."""
import collections
import json

import numpy as np
import pytest
import torch

import chip_smoke
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.ops import frame
from ocn_tpu_torch.ops import membership as M
from ocn_tpu_torch.ops import row_gather as RG
from ocn_tpu_torch.ops import window_gather as W
from ocn_tpu_torch.utils import profiling

TINY = dict(batch_size=1024, testbs=1024, linkbatchsize=128, hiddim=16)


def _counting(fn, key=None):
    """fn, counting its calls as the kernel wrappers count launches, and by
    ``key(*args)`` as membership's counts them by (rows, Kq, Ks)."""
    def wrapped(*args, **kwargs):
        wrapped.launches += 1
        if key is not None:
            wrapped.shapes[key(*args)] += 1
        return fn(*args, **kwargs)
    wrapped.launches = 0
    wrapped.shapes = collections.Counter()
    return wrapped


def _membership_shape(q, ids, w):
    return (q.numel() // q.shape[-1], q.shape[-1], ids.shape[-1])


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    membership = _counting(M.membership_counts, _membership_shape)
    monkeypatch.setattr(M, "membership_counts", membership)
    monkeypatch.setattr(frame, "membership_counts", membership)
    monkeypatch.setattr(W, "window_rows", _counting(W.window_rows))
    monkeypatch.setattr(RG, "row_rows", _counting(RG.row_rows))
    monkeypatch.setattr(RG, "sorted_block_rows", _counting(RG.sorted_block_rows))


def test_slice_phases_on_cpu(on_cpu, capsys):
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    launches = chip_smoke.phase_slice(ds, 0.0, **TINY)
    train, evals = chip_smoke.phase_window_slice(ds, **TINY)
    # 3 steps of 16 chunks: two membership lookups and one window copy each
    assert launches > 2 * 16 * 3 and train["membership"] == 2 * 16 * 3
    assert train["window"] == 16 * 3 and evals["window"] > 0
    by_kq = train["membership_by_kq"]
    assert set(by_kq) == {"16", "64"} and sum(by_kq.values()) == train["membership"]
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["phase"] for line in lines] == ["slice", "window_slice"]
    assert lines[1]["chunk_score_max_abs_err"] == 0.0


def test_reference_phase_on_cpu(on_cpu, capsys):
    chip_smoke.phase_reference()
    line = json.loads(capsys.readouterr().out)
    assert np.isfinite(line["loss_cpu"] + line["window_loss_cpu"]).all()


def test_bench_and_gather_phases_on_cpu(on_cpu, capsys):
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    launches, shapes = chip_smoke.phase_bench_slice(ds, **TINY)
    sizes = dict(m=2048, n=1500, h=16, e2=9000, b2=64, k2=64, ts=256, w=512)
    g_launches, variants = chip_smoke.phase_gather_bench(iters=1, warmup=0,
                                                         **sizes)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == ["bench_slice", "gather_bench"]
    bench = lines[0]
    # 8 + 8 chunks a step: the small and the big body one group each
    assert bench["split"] == [4, 4] and bench["groups_per_step"] == 2
    assert bench["membership_launches_per_step"] == [4, 4, 4]
    assert launches == 12 + bench["membership_launches_eval"]
    assert (bench["x_dtype"], bench["h_dtype"]) == ("torch.bfloat16", "torch.float32")
    assert bench["group_score_max_abs_err"] == 0.0
    # membership by (rows, Kq, Ks): a group is 8 chunks of 128 rows, and
    # the small body's queries are k_small = 16 wide
    assert sum(shapes.values()) == 12
    assert {rows for rows, _, _ in shapes} == {8 * 128}
    assert {kq for _, kq, _ in shapes} == {16, 64}
    assert bench["membership_shapes"] == [[*s, n] for s, n in shapes.items()]
    # the profiled step: host tracing only here, no device numbers
    prof = bench["step_profile"]
    assert np.isfinite(prof["loss"]) and prof["window_ms"] > 0
    assert prof["device_busy_share"] is None and prof["top_kernels"] == []
    # the instrument, one check and one timed call per variant: the row
    # kernel on random and sorted ids, the window and sorted-block kernels
    assert g_launches == {"row_rows": 4, "sorted_block_rows": 2, "window_rows": 2}
    assert set(variants) == {"xla", "xla_sorted", "pallas", "pallas_srt",
                             "window_xla", "window_dma", "onehot_mxu"}


@pytest.mark.parametrize("intervals,lo,hi,want", [
    ([], 0.0, 10.0, 0.0),
    ([("a", 1.0, 3.0), ("b", 5.0, 6.0)], 0.0, 10.0, 3.0),
    ([("a", 1.0, 4.0), ("b", 2.0, 3.0), ("c", 3.5, 5.0)], 0.0, 10.0, 4.0),
    ([("a", -2.0, 1.0), ("b", 9.0, 12.0)], 0.0, 10.0, 2.0),  # clipped
    ([("a", 11.0, 12.0)], 0.0, 10.0, 0.0),                  # outside
])
def test_busy_union(intervals, lo, hi, want):
    """The device-busy time of a step: overlapping activities (kernels on
    other streams, memcpys) count once, time outside the window not at all."""
    assert profiling.busy_us(intervals, lo, hi) == want


def test_step_breakdown_ranks_kernels():
    iv = [("gemm", 0.0, 400.0), ("copy", 500.0, 600.0), ("copy", 650.0, 750.0),
          ("tiny", 800.0, 801.0), ("late", 2000.0, 2100.0)]
    out = profiling.step_breakdown(iv, (0.0, 1000.0), n=2)
    assert out["window_ms"] == 1.0 and out["device_activities"] == 4
    assert out["device_busy_share"] == pytest.approx(0.601)
    assert out["top_kernels"] == [
        {"name": "gemm", "ms": 0.4, "launches": 1},
        {"name": "copy", "ms": 0.2, "launches": 2}]

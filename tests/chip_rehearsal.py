"""The CPU set-up of chip_smoke.py's rehearsals (tests/test_torch_chip_smoke*.py).
Not a test file: pytest collects nothing here, apart from the fixtures
``on_cpu`` and ``one_thread`` (tests/torch_parity.py) that each rehearsal
module imports.

The script itself needs a card; under ``on_cpu`` its ``DEVICE`` is the CPU,
the CUDA synchronisation and memory calls are no-ops, and the kernel
wrappers are wrapped to count their (plain-version) calls, so the phases'
own checks (launch counts, finite losses, Hits ranges, kernel-against-plain
scores) run as they do on the card."""
import collections

import pytest
import torch

import chip_smoke
from ocn_tpu_torch.ops import frame
from ocn_tpu_torch.ops import membership as M
from ocn_tpu_torch.ops import row_gather as RG
from ocn_tpu_torch.ops import segment_sum as SS
from ocn_tpu_torch.ops import window_gather as W
from torch_parity import one_thread  # noqa: F401 (re-exported, autouse where imported)

TINY = dict(batch_size=1024, testbs=1024, linkbatchsize=128, hiddim=16)

# chip_smoke.reference_cases() in two files, so that pytest-xdist's
# --dist loadfile runs them on two workers: the frame-based family on the
# collab-like Cora graph, then the "ho" stack, SDDMM and the incomplete
# family
FRAME_CASES = ("plain", "window", "grouped", "cn7", "cn7_window", "cn8", "cn9",
               "cn1", "cn6", "hoisted_cn5")
STACK_CASES = ("ppa", "citation2", "spd", "cn2", "cn3", "cn2_depth2",
               "cn2_learnpt")


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
    # the segment sum's wrapper counts its plain version's calls as launches
    plain = SS.segment_sum_plain

    def segment_sum_plain(src, off, idx=None, scale=None):
        SS.segment_sum_raw.launches += 1
        return plain(src, off, idx, scale)

    monkeypatch.setattr(SS, "segment_sum_plain", segment_sum_plain)
    monkeypatch.setattr(SS.segment_sum_raw, "launches", 0)

"""chip_smoke.py's model phases rehearsed on the CPU at a tiny size.

The script itself needs a card; here its ``DEVICE`` is the CPU, the CUDA
synchronisation and memory calls are no-ops, and the two kernel wrappers
are wrapped to count their (plain-version) calls, so the phases' own checks
(launch counts, finite losses, Hits ranges, kernel-against-plain chunk
scores) run as they do on the card."""
import json

import numpy as np
import pytest
import torch

import chip_smoke
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.ops import frame
from ocn_tpu_torch.ops import membership as M
from ocn_tpu_torch.ops import window_gather as W

TINY = dict(batch_size=1024, testbs=1024, linkbatchsize=128, hiddim=16)


def _counting(fn):
    def wrapped(*args):
        wrapped.launches += 1
        return fn(*args)
    wrapped.launches = 0
    return wrapped


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    membership = _counting(M.membership_counts)
    monkeypatch.setattr(M, "membership_counts", membership)
    monkeypatch.setattr(frame, "membership_counts", membership)
    monkeypatch.setattr(W, "window_rows", _counting(W.window_rows))


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

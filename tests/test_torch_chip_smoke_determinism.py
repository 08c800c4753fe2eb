"""chip_smoke.py's segment-sum phases rehearsed on the CPU at a tiny size:
``segment_sum_shapes`` on the calls that bench_slice makes, the
``determinism`` phase (bench_slice's program, arm 1 of the accuracy study
and a cn3 step, each twice from seed 0, bit for bit), its bisection of a
program that differs, the segment sum's entry of the kernels line, and
``captured_step`` (bench_slice's program eager and through the step
program, bit for bit; on the CPU both run eagerly)."""
import json

import pytest
import torch

import chip_smoke
from chip_rehearsal import TINY, on_cpu, one_thread  # noqa: F401 (fixtures)
from ocn_tpu_torch.data.loaders import synthetic_dataset


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_segment_sum_shapes_on_cpu(on_cpu, capsys):
    """Every site of the main path appears once a shape, with its launches."""
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    with chip_smoke.captured_segment_sums() as calls:
        chip_smoke.phase_bench_slice(ds, **TINY)
    timings, err = chip_smoke.phase_segment_sum_shapes(calls)
    assert calls == {} and err == 0.0
    sites = {t["site"] for t in timings}
    assert {"spmm.py:forward", "spmm.py:backward", "frame.py:_col_sum_map",
            "frame.py:_segment_dx", "csr.py:value_rowsum"} <= sites
    assert all(t["launches"] > 0 for t in timings)
    lines = _lines(capsys)
    assert [line["phase"] for line in lines] == ["bench_slice", "segment_sum_shapes"]
    bench = lines[0]
    assert all(n > 0 for n in bench["segment_sum_launches_per_step"])
    assert bench["segment_sum_launches_eval"] > 0


def test_determinism_phase_on_cpu(on_cpu, capsys):
    """The three programs twice each, at a tiny size: nothing differs, and
    each compares its losses, state and eval scores."""
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    out = chip_smoke.phase_determinism(ds, accuracy_scale=0.25, accuracy_epochs=2,
                                       **TINY)
    (line,) = _lines(capsys)
    assert line["phase"] == "determinism"
    assert set(out) == {"bench_slice", "accuracy_arm1", "family_cn3"}
    assert all(rec["first_mismatch"] is None for rec in out.values())
    # three steps, five eval splits, the state's parameters and Adam moments
    assert out["bench_slice"]["losses"] == 3 and out["bench_slice"]["score_splits"] == 5
    assert out["bench_slice"]["tensors"] > 3 + 5 + 50
    assert out["family_cn3"]["losses"] == 1 and out["family_cn3"]["score_splits"] == 0
    acc = out["accuracy_arm1"]
    assert acc["losses"] > 0 and acc["score_splits"] > 0
    assert 0.0 <= acc["best_test_hits50"] <= 1.0


def test_determinism_phase_names_the_op_apart(on_cpu, monkeypatch, capsys):
    """A program that draws from the unseeded global generator differs
    between its two runs: the phase fails and names the draw as the first
    op apart, after the ops that agreed."""
    def programs(ds, scale, epochs, overrides):
        def prog():
            x = torch.ones(4) * 2.0
            return {"y": (x + torch.rand(4)).sum()[None]}
        return {"unseeded": prog}

    monkeypatch.setattr(chip_smoke, "determinism_programs", programs)
    with pytest.raises(AssertionError, match="unseeded"):
        chip_smoke.phase_determinism(None)
    rec = _lines(capsys)[0]["unseeded"]
    assert rec["first_mismatch"]["name"] == "y" and rec["tensors"] == 1
    apart = rec["first_op_apart"]
    assert "rand" in apart["op"] and apart["ops_before"] >= 1


def test_segment_sum_entry_requires_every_main_phase():
    timing = {"ms": 1.0, "device_ms": 0.5, "plain_ms": 2.0, "bound_ms": 0.1,
              "bound_by": "bytes", "library_ms": 3.0, "shape": [4, 2, 1]}
    by_phase = {k: 2 for k in chip_smoke.SEGMENT_SUM_MAIN}
    entry = chip_smoke.segment_sum_entry(1e-7, timing, by_phase, [], 2e-7)
    assert entry["launches"] == 2 * len(chip_smoke.SEGMENT_SUM_MAIN)
    assert entry["route"] == "cuda" and entry["max_abs_err"] == 2e-7
    assert entry["source"] == "ocn_tpu_torch/csrc/segment_sum.cu"
    by_phase["accuracy_slice"] = 0
    with pytest.raises(AssertionError, match="accuracy_slice"):
        chip_smoke.segment_sum_entry(1e-7, timing, by_phase, [], 0.0)


def test_captured_step_phase_on_cpu(on_cpu, capsys):
    """bench_slice's program through Trainer(..., capture=False) and through
    the default step program: the same bits, launches a step and profiles."""
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    out = chip_smoke.phase_captured_step(ds, **TINY)
    line = _lines(capsys)[0]
    assert line["phase"] == "captured_step" and line["first_mismatch"] is None
    assert line["tensors"] > 3
    for mode in ("eager", "captured"):
        rec = line[mode]
        assert rec["membership_launches_per_step"] == [4, 4, 4]
        assert min(rec["segment_sum_launches_per_step"]) > 0
        assert rec["program"] == {"captured": False, "capture_s": None, "replays": 0}
        assert rec["step_profile"]["window_ms"] > 0
    assert out["eager"]["losses"] == out["captured"]["losses"]

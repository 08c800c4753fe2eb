"""chip_smoke.py's entry-point phases rehearsed on the CPU
(tests/chip_rehearsal.py): the port's bench program in-process, at its
defaults and in its window-table variant, and cli.run with checkpoints,
embedding export, profile trace, metrics log, resume and HPO trials.  As on
the card, no tensorboard package is importable."""
import json
import os
import sys

import numpy as np
import pytest

import chip_smoke
from chip_rehearsal import on_cpu, one_thread  # noqa: F401 (fixtures)

BENCH_TINY = dict(OCN_BENCH_SCALE="0.01", OCN_BENCH_BATCH="1024",
                  OCN_BENCH_CHUNK="128", OCN_BENCH_STEPS="1", OCN_BENCH_PAIR="0")


@pytest.fixture
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_bench_program_phase_on_cpu(on_cpu, monkeypatch, capsys):
    monkeypatch.setenv("OCN_BENCH_GROUP", "4")  # cleared for the phase's runs
    launches, window = chip_smoke.phase_bench_program(
        env=BENCH_TINY, anchors=dict(n=5000, b=256, mm=64))
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "bench_program"
    defaults, variant = line["defaults"], line["window_variant"]
    assert defaults["env"] == {**BENCH_TINY, "OCN_BENCH_PLATFORM": "cpu"}
    for run in (defaults, variant):
        bench = run["line"]
        assert bench["metric"] == "train_edges_per_s_cn5_collab"
        assert bench["value"] > 0 and bench["anchor_rowgather_ms"] > 0
        assert "vs_defaults" not in bench
    # 3 steps (two untimed: on the card the step program's warm-up and
    # capture) of 16 chunks in frame groups of 8 with the dual-K split: 2
    # groups, 2 lookups each
    assert defaults["membership_launches"] == 3 * 2 * 2
    assert defaults["window_launches"] == 0
    # the window table: one window copy a chunk
    assert variant["window_launches"] == window == 3 * 16
    assert launches == defaults["membership_launches"] + variant["membership_launches"]
    # the knobs of the runs are gone again, the ones set before are back
    assert os.environ["OCN_BENCH_GROUP"] == "4" and "OCN_BENCH_SCALE" not in os.environ


def test_cli_phase_on_cpu(on_cpu, no_tensorboard, capsys):
    launches = chip_smoke.phase_cli_slice(hiddim=16)
    line = json.loads([x for x in capsys.readouterr().out.splitlines()
                       if x.startswith('{"phase"')][-1])
    assert line["phase"] == "cli_slice" and launches == line["membership_launches"] > 0
    assert line["config"]["model"] == "puregcn" and line["config"]["epochs"] == 2
    # hyperparameters, then 3 Hits keys for each of 2 epochs
    assert line["metrics_records"] == 1 + 3 * 2
    assert line["resumed_step"] == line["checkpoint_steps"][-1]
    assert line["restored_adam_tensors"] > 0
    assert line["gemb_shape"][1] == 16
    assert len(line["hpo_trials"]) == 2 and np.isfinite(line["hpo_trials"]).all()
    assert line["hpo_best_val"] == max(line["hpo_trials"])
    assert line["trace_membership_names"] == []  # no device trace on the CPU

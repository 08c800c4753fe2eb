"""chip_smoke.py's instrument phases rehearsed on the CPU at a tiny size
(tests/chip_rehearsal.py): eval_bench (the eval instrument's three arms on
one live Trainer, collab at scale 0.01, batch 2,048, hidden 16, 1 layer,
frame widths over every row), mrr_bench
(the MRR instrument on a citation2 stand-in at scale 0.005, 16 sources a
split with 1,000 negatives each) and scaling_bench (the weak-scaling harness
in its three modes at dp 1 and 2 on gloo ranks, 64 links a rank, one timed
step).  Each phase prints its line and its program's lines, and its launches
reach membership's entry of the kernels line."""
import json

import numpy as np

import chip_smoke
from chip_rehearsal import on_cpu, one_thread  # noqa: F401 (fixtures)
from ocn_tpu_torch.data.loaders import synthetic_dataset

# frame widths over every row (degrees up to 122, A^2 capped at 128 on the
# host): no row is sampled, so the arms differ only in the order the dual-K
# split scores the train positives, the one split longer than a batch
EVAL_TINY = dict(hiddim=16, mplayers=1, pad_deg=128, pad_deg2=128, adj2_cap=128)
MRR_TINY = dict(OCN_BENCH_SCALE="0.005", OCN_BENCH_MRR_CAP="16",
                OCN_BENCH_TESTBS="4096")


def _phase_line(out, name):
    lines = [json.loads(x) for x in out.splitlines() if x.startswith('{"phase"')]
    assert [line["phase"] for line in lines] == [name]
    return lines[0]


def test_instrument_phases_on_cpu(on_cpu, capsys):
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    e_launches, e_shapes = chip_smoke.phase_eval_bench(
        ds, env={"OCN_BENCH_BATCH": "2048"}, **EVAL_TINY)
    out = capsys.readouterr().out
    line = _phase_line(out, "eval_bench")
    assert [a["arm"] for a in line["arms"]] == ["ell=1 dualK=1", "ell=1 dualK=0",
                                                "ell=0 dualK=0"]
    assert line["ell_tables"] and line["testbs"] == 2048
    for arm in line["arms"]:
        assert arm["line"] in out.splitlines()  # the script's own line
        assert arm["membership_launches"] > 0 and arm["edges_per_s"] > 0
        assert sum(n for *_, n in arm["membership_shapes"]) == arm["membership_launches"]
    # valid and test score alike in every arm here
    first = line["arms"][0]["hits"]
    assert all(a["hits"][k][1:] == first[k][1:] for a in line["arms"][1:]
               for k in first)
    assert line["rescore_launches"] > 0 and line["rescore_max_abs_err"] == 0.0
    assert line["plain_membership_calls"].get("cuda", 0) == 0
    assert e_launches == sum(a["membership_launches"] for a in line["arms"])
    assert sum(e_shapes.values()) == e_launches

    mds, data = chip_smoke.mrr_dataset_job(0.005, 16)
    assert data["n_scored"] == 2 * 16 * 1001
    m_launches, m_shapes = chip_smoke.phase_mrr_bench(mds, data, env=MRR_TINY)
    out = capsys.readouterr().out
    line = _phase_line(out, "mrr_bench")
    assert out.splitlines()[-1].startswith("evaluate_mrr (scale 0.005, ")
    assert all(0 < v <= 1 for v in line["mrr"].values()) and line["ell_tables"]
    assert m_launches == line["membership_launches"] == sum(m_shapes.values()) > 0

    s_launches, s_shapes = chip_smoke.phase_scaling_bench(dps=(1, 2), per_dev=64,
                                                          steps=1)
    out = capsys.readouterr().out
    line = _phase_line(out, "scaling_bench")
    assert line["backend"] == {"1": "gloo", "2": "gloo"}
    for mode in ("spmd", "sharded", "sharded_prod"):
        rows = line["modes"][mode]
        assert [r["dp"] for r in rows] == [1, 2] and rows[0]["efficiency"] == 1.0
        for r in rows:
            assert r["line"] in out.splitlines()
            assert len(r["losses"]) == r["dp"] and np.isfinite(r["losses"]).all()
            assert min(r["membership_launches"]) > 0
        # the ranks of a dp read the same loss
        assert len({ls[0] for ls in rows[1]["losses"]}) == 1
    assert s_launches == line["membership_launches"] > 0
    assert not s_shapes  # counted by shape on the card only

    # membership's entry of the kernels line carries each phase's launches
    timing = dict(ms=0.1, device_ms=0.01, plain_ms=0.2, bound_ms=0.001,
                  bound_by="bytes")
    by_phase = {k: 1 for k in chip_smoke.MEMBERSHIP_MAIN}
    by_phase.update(eval_bench=e_launches, mrr_bench=m_launches,
                    scaling_bench=s_launches)
    entry = chip_smoke.membership_entry(0.0, timing, by_phase, [])
    assert (entry["launches_eval_bench"], entry["launches_mrr_bench"],
            entry["launches_scaling_bench"]) == (e_launches, m_launches, s_launches)
    assert entry["launches"] == 4 + e_launches + m_launches + s_launches

"""chip_smoke.py's model phases rehearsed on the CPU at a tiny size.

The script itself needs a card; here its ``DEVICE`` is the CPU, the CUDA
synchronisation and memory calls are no-ops, and the kernel wrappers are
wrapped to count their (plain-version) calls, so the phases' own checks
(launch counts, finite losses, Hits ranges, kernel-against-plain chunk
scores, feature and hidden dtypes) run as they do on the card.  The step
profile runs with host tracing only: a CPU run has no device numbers."""
import json

import numpy as np
import pytest

import chip_smoke
from chip_rehearsal import FRAME_CASES, STACK_CASES, TINY, on_cpu, one_thread  # noqa: F401 (fixtures)
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.utils import profiling

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


def test_reference_phase_on_cpu(on_cpu, monkeypatch, capsys):
    """phase_reference runs every case once, in order, on datasets built
    once each, and prints one line of their keys; the cases themselves are
    rehearsed one by one in test_torch_chip_smoke_frames.py and
    test_torch_chip_smoke_stacks.py, which between them hold every case."""
    ran = []

    def case(name, datasets):
        assert set(datasets) == set(chip_smoke.REFERENCE_DATA)
        ran.append(name)
        return {f"{name}_loss_cpu": [1.0]}

    monkeypatch.setattr(chip_smoke, "reference_dataset", lambda name: name)
    monkeypatch.setattr(chip_smoke, "run_reference_case", case)
    chip_smoke.phase_reference()
    line = json.loads(capsys.readouterr().out)
    cases = list(chip_smoke.reference_cases())
    assert ran == cases and len(cases) == 17
    assert line["phase"] == "reference" and line["seconds"] >= 0
    assert all(line[f"{name}_loss_cpu"] == [1.0] for name in cases)
    assert FRAME_CASES + STACK_CASES == tuple(cases)


def test_bench_and_gather_phases_on_cpu(on_cpu, capsys):
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    launches, shapes, losses = chip_smoke.phase_bench_slice(ds, **TINY)
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
    assert losses == bench["losses"]
    # membership by (rows, Kq, Ks): a group is 8 chunks of 128 rows, and
    # the small body's queries are k_small = 16 wide
    assert sum(shapes.values()) == 12
    assert {rows for rows, _, _ in shapes} == {8 * 128}
    assert {kq for _, kq, _ in shapes} == {16, 64}
    assert bench["membership_shapes_train"] == [[*s, n] for s, n in sorted(shapes.items())]
    # the profiled step: host tracing only here, no device numbers
    prof = bench["step_profile"]
    assert np.isfinite(prof["loss"]) and prof["window_ms"] > 0
    assert prof["device_busy_share"] is None and prof["top_kernels"] == []
    # the instrument, one check and one timed call per variant: the row
    # kernel on random and sorted ids, the window and sorted-block kernels
    assert g_launches == {"row_rows": 4, "sorted_block_rows": 2, "window_rows": 2}
    assert set(variants) == {"xla", "xla_sorted", "pallas", "pallas_srt",
                             "window_xla", "window_dma", "onehot_mxu"}


def test_new_path_phases_on_cpu(on_cpu, capsys):
    """The OCNP preset, cn6 with its A^3 table, hoisted frames and the
    variants, each with the launch counts the card run asserts: 16 + 16
    chunks a step, two membership lookups a chunk for cn7, three for cn6,
    two a step when hoisted (at 2 * 1024 rows)."""
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    o_train, o_eval, o_shapes = chip_smoke.phase_ocnp_slice(ds, **TINY)
    c_train, c_eval, c_shapes = chip_smoke.phase_cn6_slice(ds, **TINY)
    h_train, h_eval, h_shapes = chip_smoke.phase_hoist_slice(ds, **TINY)
    v_launches, v_shapes = chip_smoke.phase_variants_slice(ds, **TINY)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["phase"] for line in lines] == [
        "ocnp_slice", "cn6_slice", "hoist_slice", "variants_slice"]
    ocnp, cn6, hoist, variants = lines
    assert o_train["membership_launches_per_step"] == [32] * 3
    assert c_train["membership_launches_per_step"] == [48] * 3
    assert h_train["membership_launches_per_step"] == [2] * 3
    assert h_train["membership_shapes_train"] == [[2048, 64, 64, 6]]
    # the small body queries at k_small = 16, cn6's third lookup against
    # k3 = 16 lanes of A^3
    assert {tuple(s[:3]) for s in c_train["membership_shapes_train"]} == {
        (128, 16, 64), (128, 16, 16), (128, 64, 64), (128, 64, 16)}
    assert ocnp["config"]["model"] == "gin" and ocnp["config"]["testbs"] == 1024
    assert ocnp["config"]["use_valedges_as_input"]
    assert cn6["adj3_nnz"] > 0 and cn6["k3"] == 16
    for line in (ocnp, cn6, hoist):
        assert np.isfinite(line["losses"]).all() and line["eval_s"] > 0
        assert line["membership_launches_eval"] > 0
    assert ocnp["chunk_score_max_abs_err"] == 0.0
    assert cn6["chunk_score_max_abs_err"] == 0.0
    assert hoist["group_score_max_abs_err"] == 0.0
    stepped = ("cn1", "cn8", "cn9", "cn5_cndeg32")
    assert set(variants) == {"phase", "seconds", "cn2_increasealpha_epoch7",
                             *stepped}
    # cn1 and cn9 carry two (n_nodes, hidden) one-hot weights, cn8 none
    assert (variants["cn1"]["parameters"] - variants["cn8"]["parameters"]
            > 2 * ds.n_nodes * 16 - 2 * 16 * 16 * 3)
    epoch = variants["cn2_increasealpha_epoch7"]
    # three steps of 8 + 8 chunks, four lookups a chunk
    assert epoch["alpha2"] == pytest.approx(0.2) and epoch["steps"] == 3
    assert epoch["membership_launches"] == 3 * 16 * 4
    assert v_launches == epoch["membership_launches"] + sum(
        sum(variants[n]["membership_launches_per_step"])
        + variants[n]["membership_launches_eval"] for n in stepped)
    assert sum(o_shapes.values()) == 96 + o_eval["membership_launches_eval"]


def test_family_phase_on_cpu(on_cpu, capsys):
    """family_slice at a tiny size: 8 + 8 chunks a step, four membership
    lookups a chunk for cn2 and twelve for cn3, in training and in each
    eval batch; the blocked lookups at (chunk * trndeg) rows in training
    and (testbs * 64) in eval: tstdeg 128 caps nothing in a frame of 64
    lanes, so the residual sets keep all 64."""
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    launches, shapes = chip_smoke.phase_family_slice(ds, **TINY)
    line = json.loads(capsys.readouterr().out)
    assert line["phase"] == "family_slice"
    assert line["split_rows"]["train"]["edge"] == 3 * 1024
    total = 0
    for name, per_chunk in (("cn2", 4), ("cn3", 12)):
        rec = line[name]
        assert rec["membership_launches_per_step"] == [16 * per_chunk] * 3
        assert rec["membership_launches_eval"] == per_chunk * rec["eval_batches"] > 0
        assert rec["chunk_score_max_abs_err"] == 0.0 and rec["rec_k"] == 16
        assert np.isfinite(rec["losses"]).all() and rec["eval_s"] > 0
        assert (rec["adj2_host_build_s"] > 0) == (name == "cn3")
        assert rec["largest_lookup"] == [1024 * 64, 16]
        train_rows = {s[0] for s in rec["membership_shapes_train"]}
        assert train_rows == {128, 128 * 8}
        total += sum(rec["membership_launches_per_step"]) + rec["membership_launches_eval"]
    assert launches == total == sum(shapes.values())


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


def test_negatives_entry_needs_every_main_phase():
    """The kernels line's negatives entry sums the launches of the phases
    that train epochs on the card, and fails where one never launched it."""
    timing = {"shape": [5, 8, 4], "ms": 1.0, "device_ms": 0.5, "plain_ms": 9.0,
              "host_sampler_ms": 12.0, "copy_ms": 0.2, "pinned_copy_ms": 0.1,
              **chip_smoke.bound(100, 0)}
    by_phase = {k: {"launches": 3, "rounds": 1, "short": 0}
                for k in chip_smoke.NEGATIVES_MAIN}
    by_phase["slice"] = {"launches": 0, "rounds": 0, "short": 0}
    entry = chip_smoke.negatives_entry(timing, by_phase)
    assert entry["name"] == "negatives" and entry["source"].endswith("negatives.cu")
    assert entry["launches"] == 3 * len(chip_smoke.NEGATIVES_MAIN)
    assert entry["rounds_reference"] == 1 and "launches_slice" not in entry
    assert entry["bound_ms"] == pytest.approx(1e3 * 100 / chip_smoke.PEAK_BYTES_PER_S)
    by_phase["cli_slice"]["launches"] = 0
    with pytest.raises(AssertionError, match="cli_slice"):
        chip_smoke.negatives_entry(timing, by_phase)


def test_ho_and_sddmm_phases_on_cpu(on_cpu, capsys):
    """bench.py's ppa and citation2 shapes and the spd preset at a tiny
    size, with the launch counts the card run asserts: two membership
    lookups per frame group of 8 chunks of 128 (ppa's split does not
    engage: no node has degree <= 16), one per chunk in the SDDMM mode."""
    small = dict(batch_size=1024, testbs=1024, linkbatchsize=128, hiddim=16)
    ppa, pdata = chip_smoke.new_dataset("ppa", 0.002, 4096, 1024)
    p_train, p_eval, p_shapes = chip_smoke.phase_shape_slice("ppa_slice", ppa,
                                                             pdata, **small)
    c2, cdata = chip_smoke.new_dataset("citation2", 0.002, 4096, 48)
    c_train, c_eval, c_shapes = chip_smoke.phase_shape_slice("citation2_slice", c2,
                                                             cdata, **small)
    s_train, s_eval, s_shapes = chip_smoke.phase_spd_slice(
        c2, batch_size=512, testbs=512, linkbatchsize=128, hiddim=16)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["phase"] for line in lines] == [
        "ppa_slice", "citation2_slice", "spd_slice"]
    ppa_line, c2_line, spd = lines
    assert ppa_line["split"] is None and ppa_line["groups_per_step"] == 2
    assert p_train["membership_launches_per_step"] == [4] * 3
    assert {s[0] for s in p_train["membership_shapes_train"]} == {8 * 128}
    assert ppa_line["adj2_nnz"] > 0 and ppa_line["adj2_device_gb"] > 0
    assert c2_line["split"] and c2_line["groups_per_step"] == 2
    assert c_train["membership_launches_per_step"] == [4] * 3
    assert c2_line["mrr_sources"] == {"valid": 48, "test": 48}
    assert set(c_eval["mrr"]) == {"valid", "test"}
    # 8 chunks a step, one lookup each; eval: (48 + 48 * 100) * 2 links in
    # batches of 512
    assert s_train["membership_launches_per_step"] == [8] * 3
    assert s_eval["membership_launches_eval"] == 2 * (1 + -(-48 * 100 // 512))
    assert s_train["membership_shapes_train"] == [[128, 64, 64, 24]]
    assert set(s_shapes) == {(128, 64, 64), (512, 64, 64)}
    assert spd["adj2"] is None and spd["config"]["two_hop_mode"] == "sddmm"
    for line in lines:
        assert np.isfinite(line["losses"]).all() and line["eval_s"] > 0
    assert ppa_line["hits"].keys() == {"Hits@20", "Hits@50", "Hits@100"}
    assert spd["mrr"].keys() == c2_line["mrr"].keys() == {"valid", "test"}
    assert ppa_line["group_score_max_abs_err"] == 0.0
    assert c2_line["group_score_max_abs_err"] == 0.0
    assert spd["chunk_score_max_abs_err"] == 0.0


def test_presets_phase_on_cpu(on_cpu, capsys):
    """Every README preset key takes two steps and one eval (MRR for
    citation2) at a tiny scale."""
    launches, shapes = chip_smoke.phase_presets_slice(
        {}, scale=0.1, large_scale=0.002, eval_cut=256, mrr_cut=8,
        batch_size=128, testbs=256, linkbatchsize=32, hiddim=16)
    line = json.loads(capsys.readouterr().out)
    assert line["phase"] == "presets_slice" and len(line["keys"]) == 16
    for key, rec in line["keys"].items():
        assert np.isfinite(rec["losses"]).all() and len(rec["losses"]) == 2, key
        assert min(rec["step_ms"]) > 0, key
        res = rec["mrr"] if key.startswith("citation2") else {
            k: v[1] for k, v in rec["hits"].items()}
        assert all(0.0 <= v <= 1.0 for v in res.values()), key
        steps = rec["membership_launches_per_step"]
        assert steps[0] == steps[1] > 0, key
    assert line["keys"]["citation2/spd"]["adj2_host_build_s"] == 0.0
    assert launches == sum(sum(r["membership_launches_per_step"])
                           + r["membership_launches_eval"]
                           for r in line["keys"].values())
    assert sum(shapes.values()) == launches


def test_accuracy_phase_on_cpu(on_cpu, capsys):
    """accuracy_slice through the port's instrument at sbm scale 0.25 and 2
    epochs (at 0.1 the graph's 102 train edges are fewer than the
    instrument's smallest batch, 256, and no step would run)."""
    launches, shapes = chip_smoke.phase_accuracy_slice(scale=0.25, epochs=2)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == ["accuracy_slice"]
    line = lines[0]
    rec = line["record"]
    assert (rec["graph"], rec["variant"], rec["predictor"], rec["run"]) == (
        "sbm", "capped_ell", "cn5", 0)
    assert rec["package"] == "ocn_tpu_torch" and rec["device"] == "cpu"
    assert len(rec["losses"]) == 2 and rec["losses"][1] < rec["losses"][0]
    # one step an epoch (a positive and a negative chunk) and the evals,
    # two membership lookups a chunk
    assert launches == rec["membership_launches"] == sum(shapes.values()) > 0
    assert {(kq, ks) for _, kq, ks in shapes} == {(64, 64)}
    # on the CPU the wrapper runs the plain version, never on a card tensor
    assert line["plain_membership_calls"]["cpu"] == launches
    assert "cuda" not in line["plain_membership_calls"]
    assert rec["best"]["Hits@50"][2] >= chip_smoke.ACCURACY_MIN_HITS50

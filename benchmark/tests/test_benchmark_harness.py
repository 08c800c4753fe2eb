"""The harness's pieces on the CPU: files found by name, the generator's
counts, the frozen work counts against hand counts, and what the benchmark
imports."""
import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import tiny
from harness import core, graphgen

BENCH = tiny.BENCH_DIR
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "ocn_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _py_files(BENCH):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(BENCH, "reference")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "ocn_tpu_torch" not in tops and "harness" not in tops, path


def test_top_level_names_compare_whole():
    import types
    saved = dict(sys.modules)
    try:
        sys.modules["ocn_tpu_torch_probe"] = types.ModuleType("ocn_tpu_torch_probe")
        assert core.forbidden_modules() == []
        sys.modules["ocn_tpu.probe"] = types.ModuleType("ocn_tpu.probe")
        assert core.forbidden_modules() == ["ocn_tpu.probe"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_spec_names_files_that_exist():
    spec = core.spec_file(ROOT)
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert core.load_json("configs", f"{c['name']}.json")["name"] == c["name"]
    for w in spec["workloads"]:
        wl = core.load_json("workloads", f"{w['name']}.json")
        assert (wl["config"], wl["entry"], wl["chips"], wl["why"]) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
        assert os.path.exists(os.path.join(BENCH, "entries", f"{wl['entry']}.py"))
        assert os.path.exists(os.path.join(BENCH, "reference", f"{wl['config']}.py"))
        e2e, per = core.cell_metrics(spec, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in spec["per_layer"]:
        mod = core.load_file("metrics", m["name"])
        assert mod.UNIT == m["unit"]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17, 3 * 2 ** 40 + 5])
def test_generator_counts(seed):
    g = tiny.GRAPH
    d = graphgen.make_graph(g, seed)
    n = g["n_nodes"]
    assert d["x"].shape == (n, g["n_features"]) and d["x"].dtype == np.float32
    for k in ("train", "valid", "test"):
        assert d[k].shape == (g[k], 2) and np.all(d[k][:, 0] < d[k][:, 1])
    pos = np.concatenate([d["train"], d["valid"], d["test"]])
    keys = pos[:, 0] * n + pos[:, 1]
    assert np.unique(keys).size == g["edges"]
    sym = graphgen.symmetrize(pos.T, n)
    skeys = set((sym[0] * n + sym[1]).tolist())
    for k, m in (("valid_neg", g["neg_valid"]), ("test_neg", g["neg_test"])):
        assert d[k].shape == (m, 2)
        assert not any(int(u) * n + int(v) in skeys for u, v in d[k])
        assert np.all(d[k][:, 0] != d[k][:, 1])
    again = graphgen.make_graph(g, seed)
    assert all(np.array_equal(d[k], again[k]) for k in d if k != "n")
    other = graphgen.make_graph(g, seed + 1)
    assert not np.array_equal(d["train"], other["train"])


def test_work_stats_dual_k_split():
    d = graphgen.make_graph(tiny.GRAPH, 5)
    m = tiny.config("ocn_collab")["model"]
    s = graphgen.work_stats(d, m)
    n = d["n"]
    deg = np.bincount(graphgen.symmetrize(d["train"].T, n)[0], minlength=n)
    assert s["nnz"] == 2 * tiny.GRAPH["train"] and s["chunk"] == 64 and s["chunks"] == 16
    assert s["narrow_chunks"] == int(np.mean(deg[d["train"][:, 0]] <= 4) * 8) + \
        int(np.mean(deg <= 4) * 8)
    assert s["steps_per_epoch"] == 3200 // 512
    assert s["eval_splits"]["valid"] == {"links": 400, "narrow": 0}


STATS = {"n": 10, "features": 3, "hidden": 4, "nnz": 20, "nnz_full": 22, "chunk": 2,
         "chunks": 4, "narrow_chunks": 1, "pad_deg": 3, "pad_deg2": 5, "k_small": 2,
         "testbs": 4, "steps_per_epoch": 1,
         "eval_splits": {"a": {"links": 6, "narrow": 4}, "b": {"links": 3, "narrow": 0}}}
MODEL = {"tailact": True, "twolayerlin": False, "predictor": "cn5"}


def test_flop_counts_by_hand():
    mfu_t = core.load_file("metrics", "mfu.train")
    mfu_e = core.load_file("metrics", "mfu.eval")
    # encoder: Linear 10x3x4 (120 MACs) + 20 entries x 4 (80 MACs) = 400 FLOPs
    # frames: 2 frames x 4 hidden x (1 narrow chunk x 2 links x K=2 + 3 wide x 2 x K=3) = 176 MACs
    # MLPs: 8 layers of 4x4 + a 4x1 output = 132 MACs a link, 8 links = 1056 MACs
    fwd = 400 + 2 * 176 + 2 * 1056
    assert mfu_t.step_flops(STATS, MODEL) == 3 * fwd
    # two encoders: 2 x 120 + (20 + 22) x 4 MACs; 9 links x 132 MACs;
    # frames 2 x 4 x (4 x 2 + 2 x 3 + 3 x 3) MACs
    assert mfu_e.evaluate_flops(STATS, MODEL) == 2 * (240 + 168 + 9 * 132 + 8 * 23)


def test_byte_counts_by_hand():
    mem_t = core.load_file("metrics", "membership_roofline.train")
    mem_e = core.load_file("metrics", "membership_roofline.eval")
    seg = core.load_file("metrics", "segment_sum_roofline.train")
    # a lookup of 2 rows, 3 queries against 5 entries: 2 x (12 + 40) read + 24 written
    assert mem_t.lookup_bound_s(2, 3, 5) == max(128 / 3.35e12, 60 / 67e12)
    want = 2 * (mem_t.lookup_bound_s(2, 2, 5) + 3 * mem_t.lookup_bound_s(2, 3, 5))
    assert mem_t.step_bound_s(STATS) == pytest.approx(want)
    # split a: 1 narrow batch, 1 wide (2 links padded to 4); split b: 1 wide
    want = 2 * (mem_e.lookup_bound_s(4, 2, 5) + 2 * mem_e.lookup_bound_s(4, 3, 5))
    assert mem_e.evaluate_bound_s(STATS) == pytest.approx(want)
    # SpMM: 10 rows x 4 read, 10 x 4 written, 11 offsets, 20 entries x 8 B
    spmm = (160 + 160 + 88 + 160) / 3.35e12
    assert seg.sum_bound_s(10, 4, 10, 20, 8) == spmm
    narrow = seg.sum_bound_s(4, 3, 4, 4, 8) + seg.sum_bound_s(4, 4, 10, 4, 8)
    wide = seg.sum_bound_s(6, 3, 6, 6, 8) + seg.sum_bound_s(6, 4, 10, 6, 8)
    assert seg.step_bound_s(STATS, MODEL) == pytest.approx(2 * spmm + narrow + 3 * wide)


@pytest.mark.parametrize("config", ["ocn_collab", "ocnp_collab"])
def test_segment_sum_bound_counts_every_sum_a_step_launches(config, monkeypatch):
    """The sums of one training step at a tiny size, as the program calls
    them (width, segments, entries summed), are those ``step_sums`` counts,
    one for one (the adjacency's sums run over its 4,096 zero pad entries
    too, which the bound does not count as work); a predictor it does not
    count stops with its name."""
    from harness import program
    from ocn_tpu_torch.ops import segment_sum as S
    from ocn_tpu_torch.train.loop import Trainer

    seg = core.load_file("metrics", "segment_sum_roofline.train")
    cfg = tiny.config(config)
    data = graphgen.make_graph(cfg["graph"], 5)
    pc = program.program_config(cfg)
    tr = Trainer(pc, program.dataset(data, pc.dataset, pc.use_valedges_as_input), "cpu")
    state = tr.init_state(5)
    calls, plain = [], S.segment_sum_plain

    def recorded(src, off, idx=None, scale=None):
        calls.append((1 if src.dim() == 1 else src.shape[1], off.numel() - 1, int(off[-1])))
        return plain(src, off, idx, scale)

    class OneStep(Exception):
        pass

    step = tr.train_step

    def one(*a):
        calls.clear()
        step(*a)
        raise OneStep

    monkeypatch.setattr(S, "segment_sum_plain", recorded)
    tr.train_step = one
    with pytest.raises(OneStep):
        tr.train_epoch(state, graphgen.train_rng(5), 1)
    stats = graphgen.work_stats(data, cfg["model"])
    counted = [(w, s, e + (4096 if e == stats["nnz"] else 0))
               for _, w, s, e, _ in seg.step_sums(stats, cfg["model"])]
    assert sorted(calls) == sorted(counted)
    with pytest.raises(ValueError, match="'cn3'"):
        seg.step_sums(stats, dict(cfg["model"], predictor="cn3"))


def test_interval_arithmetic():
    from harness import tracing
    iv = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("a", 20.0, 25.0), ("c", 40.0, 41.0)]
    assert tracing.busy_us(iv, 0.0, 50.0) == 18.0
    assert tracing.busy_us(iv, 8.0, 22.0) == 6.0
    assert tracing.top_kernels(iv, 2) == [["a", 15e-6], ["b", 7e-6]]
    # host samples (host clock, s); the trace's clock runs 100 us ahead
    samples = [(-1e-4 + t * 1e-6, lab) for t, lab in
               ((2.0, "a"), (27.0, "neg"), (30.0, "neg"), (33.0, "prep"), (45.0, "read"))]
    gaps = tracing.idle_gaps(iv, samples, 0.0, 50.0, 100.0, n=3)
    assert gaps == [["neg", 15e-6], ["read", 9e-6], ["neg", 8e-6]]


def test_host_sampler_names_the_programs_frame():
    import time
    from harness import tracing
    from ocn_tpu_torch.sparse import build
    n = 3000
    ei = np.stack([np.arange(n - 1), np.arange(1, n)])
    with tracing.HostSampler(period=0.001) as s:
        t_end = time.perf_counter() + 0.3
        while time.perf_counter() < t_end:
            build.symmetrize_edge_index(ei, n)
    labels = {lab for _, lab in s.samples}
    assert any("build.py" in lab and "symmetrize_edge_index" in lab for lab in labels), labels


def _copy_benchmark(tmp):
    dst = os.path.join(tmp, "checkout")
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    return dst


def test_new_config_cell_and_metric_need_only_new_files(tmp_path):
    """A configuration, a cell and a per-layer metric added as files (and
    entries of BENCHMARK.json), with no file of the harness edited, are
    found and run (on the CPU, at a tiny size)."""
    dst = _copy_benchmark(str(tmp_path))
    bench = os.path.join(dst, "benchmark")
    cfg = tiny.config("ocn_collab")
    cfg["name"] = "ocn_tiny"
    with open(os.path.join(bench, "configs", "ocn_tiny.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(bench, "reference", "ocn_collab.py"),
                os.path.join(bench, "reference", "ocn_tiny.py"))
    wl = json.load(open(os.path.join(bench, "workloads", "ocn_collab_eval.json")))
    wl["config"] = "ocn_tiny"
    wl["why"] = "a tiny cell"
    with open(os.path.join(bench, "workloads", "tiny_eval.json"), "w") as f:
        json.dump(wl, f)
    with open(os.path.join(bench, "metrics", "links_per_unit.tiny.py"), "w") as f:
        f.write('UNIT = "links"\n\n\ndef read(ctx):\n    return ctx["units"][0]["links"]\n')
    spec = json.load(open(os.path.join(dst, "BENCHMARK.json")))
    spec["configs"].append({"name": "ocn_tiny", "source": "x", "file": "benchmark/configs/ocn_tiny.json",
                            "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": "tiny_eval", "config": "ocn_tiny", "traffic": "evaluate",
                              "chips": 1, "why": "a tiny cell"})
    spec["end_to_end"][1]["workloads"].append("tiny_eval")
    spec["per_layer"].append({"name": "links_per_unit.tiny", "unit": "links", "better": "higher",
                              "source": "program_counter", "layer": "eval scoring",
                              "moves": "eval_links_per_s", "workloads": ["tiny_eval"]})
    spec["per_layer"][-2]["workloads"].append("tiny_eval")
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "import torch; torch.set_num_threads(2)\n"
            "from harness import core\n"
            "for t in (False, True):\n"
            "    out = core.run('tiny_eval', 7, 0.5, t, device='cpu')\n"
            "    print(json.dumps(out))\n") % (ROOT, bench)
    res = subprocess.run([sys.executable, "-c", code], cwd=dst, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = [json.loads(x) for x in res.stdout.strip().splitlines()[-2:]]
    assert plain["correct"] and set(plain["metrics"]) == {"eval_links_per_s", "peak_mem_gib", "setup_s"}
    assert traced["correct"] and traced["metrics"]["links_per_unit.tiny"]["value"] == 3200 + 4 * 400
    assert "warm_s" in traced["metrics"]


def test_run_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "ocn_collab_eval", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    exits non-zero and prints no result."""
    dst = _copy_benchmark(str(tmp_path))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ocn_collab_eval",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=dst, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""

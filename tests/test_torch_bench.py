"""Port parity: the bench program (ocn_tpu_torch/scripts/bench.py) against
the root bench.py.  Its losses cannot match (the JAX program folds a
dropout key per step, the port draws from one generator), so what is held
equal is what both build: the Config, field for field, for the defaults
and the variants; the negatives and the pre-staged batches; and the JSON
line main() assembles from a measurement.  A run at a tiny size on the CPU
prints one line with the JAX program's keys."""
import dataclasses
import json

import numpy as np
import pytest

import bench as jbench
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.scripts import bench as tbench
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

KNOBS = list(tbench._VARIANT_ENVS) + [
    "OCN_BENCH_STEPS", "OCN_BENCH_PAIR", "OCN_BENCH_ANCHORS",
    "OCN_BENCH_PLATFORM", "OCN_BENCH_PPA_SHAPE"]
TINY = dict(OCN_BENCH_SCALE="0.01", OCN_BENCH_BATCH="1024",
            OCN_BENCH_CHUNK="128", OCN_BENCH_STEPS="3")


@pytest.fixture
def knobs(monkeypatch):
    """A clean OCN_BENCH_* environment; returns a setter."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)

    def set_knobs(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return set_knobs


class _Stop(Exception):
    pass


def jax_program(monkeypatch, capture_inputs=False):
    """Run the root bench.py's measure up to its first train_step and
    return what it built: the Config, the dataset scale and, with
    ``capture_inputs``, every prepare_batch call's (pos, neg, idx).
    Without it the dataset is a small stand-in and no trainer is built."""
    import ocn_tpu.data.loaders as jloaders
    import ocn_tpu.train.loop as jloop

    seen = {"inputs": []}
    synthetic = jloaders.synthetic_dataset

    def dataset(name, seed=0, scale=1.0):
        seen["scale"] = scale
        if capture_inputs:
            return synthetic(name, seed=seed, scale=scale)
        return synthetic("Cora", seed=seed, scale=0.05)

    class Trainer(jloop.Trainer):
        def __init__(self, cfg, ds):
            seen["cfg"] = cfg
            if not capture_inputs:
                raise _Stop
            super().__init__(cfg, ds)
            self.train_step = self.stop  # __init__ binds the jitted step

        def init_state(self, seed):
            return None

        def prepare_batch(self, pos_b, neg_b, idx=None):
            seen["inputs"].append((pos_b, neg_b, idx))
            return super().prepare_batch(pos_b, neg_b, idx)

        def stop(self, *args):
            raise _Stop

    monkeypatch.setattr(jloaders, "synthetic_dataset", dataset)
    monkeypatch.setattr(jloop, "Trainer", Trainer)
    with pytest.raises(_Stop):
        jbench.measure()
    return seen


@pytest.mark.parametrize("env", [
    {},
    {"OCN_BENCH_PREDICTOR": "cn2", "OCN_BENCH_RECK": "16"},
    {"OCN_BENCH_DATASET": "citation2"},
    {"OCN_BENCH_DATASET": "ddi"},
    {"OCN_BENCH_DATASET": "ppa"},
    {"OCN_BENCH_WINDOW": "1"},
    {"OCN_BENCH_DATASET": "ppa", "OCN_BENCH_PPA_SHAPE": "collab",
     "OCN_BENCH_PREEDP": "0.0", "OCN_BENCH_SCALE": "0.5", "OCN_BENCH_HOIST": "1"},
], ids=["defaults", "cn2_reck16", "citation2", "ddi", "ppa", "window",
        "ppa_collab_shape"])
def test_config_equals_jax(knobs, monkeypatch, env):
    knobs(**env)
    want = jax_program(monkeypatch)
    cfg, scale, steps, reorder = tbench.bench_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want["cfg"])
    assert scale == want["scale"] and steps == 10 and reorder
    # the paired denominator: the defaults program whatever the knobs say
    paired = tbench.bench_config(defaults=True)[0]
    for k in env:
        monkeypatch.delenv(k)
    assert dataclasses.asdict(paired) == dataclasses.asdict(tbench.bench_config()[0])


@pytest.mark.parametrize("dataset", ["collab", "citation2"])
def test_negatives_and_batches_equal_jax(knobs, monkeypatch, dataset):
    knobs(**TINY, OCN_BENCH_DATASET=dataset)
    want = jax_program(monkeypatch, capture_inputs=True)
    cfg, scale, steps, _ = tbench.bench_config()
    ds = tsynthetic(dataset, seed=0, scale=scale).reorder_bfs()
    pos, neg, idxs = tbench.bench_inputs(ds, cfg, steps)
    assert len(idxs) == len(want["inputs"]) == 3
    for idx, (jpos, jneg, jidx) in zip(idxs, want["inputs"]):
        assert len(idx) == cfg.batch_size
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(pos[:, idx], jpos)
        np.testing.assert_array_equal(neg[:, idx], jneg)


@pytest.mark.parametrize("env", [
    {}, {"OCN_BENCH_DATASET": "ddi"},
    {"OCN_BENCH_WINDOW": "1"}, {"OCN_BENCH_WINDOW": "1", "OCN_BENCH_PAIR": "0"},
], ids=["defaults", "ddi", "window_paired", "window_unpaired"])
def test_line_equals_jax(knobs, monkeypatch, capsys, env):
    """main() around one measurement (the variant 123456.78 links/s, the
    defaults 100000): the same line as bench.py's main, key for key."""
    knobs(OCN_BENCH_ANCHORS="0", **env)

    def measure(defaults=False, **_):
        return ("m_defaults" if defaults else "m"), (1e5 if defaults else 123456.78)

    monkeypatch.setattr(jbench, "measure", measure)
    monkeypatch.setattr(tbench, "measure", measure)
    jbench.main()
    want = capsys.readouterr().out
    rec = tbench.main()
    got = capsys.readouterr().out
    assert got == want and json.loads(got) == rec
    assert ("vs_defaults" in rec) == (env.get("OCN_BENCH_PAIR") != "0" and bool(env))


def test_main_on_cpu_prints_the_jax_keys(knobs, monkeypatch, capsys):
    """The program itself at a tiny size on the CPU, with small anchors: one
    line, bench.py's keys; as a variant (OCN_BENCH_PAIR=1) it adds the
    paired run, whose defaults program at full size is no CPU test: it
    stands in with the variant's own measurement."""
    knobs(**{**TINY, "OCN_BENCH_STEPS": "1"}, OCN_BENCH_PLATFORM="cpu")
    measure = tbench.measure
    runs = []

    def measured_once(defaults=False, device="cuda"):
        if not defaults:
            runs.append(measure(False, device))
        return runs[0]

    monkeypatch.setattr(tbench, "measure", measured_once)
    rec = tbench.main(anchors=dict(n=5000, b=256, mm=64))
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in lines] == [rec]
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "anchor_rowgather_ms", "anchor_matmul_tflops",
                        "ref_defaults_metric", "ref_defaults_value", "vs_defaults"}
    assert rec["metric"] == rec["ref_defaults_metric"] == "train_edges_per_s_cn5_collab"
    assert rec["value"] > 0 and rec["anchor_rowgather_ms"] > 0
    assert rec["vs_defaults"] == 1.0 and len(runs) == 1


def test_anchors_are_chained_and_sized_by_keywords():
    g_ms, tflops = tbench.chip_anchors("cpu", n=2000, b=128, mm=32,
                                       gather_reps=3, matmul_reps=2)
    assert g_ms > 0 and tflops >= 0

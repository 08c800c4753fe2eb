"""Port parity: the MRR eval instrument (ocn_tpu_torch/scripts/bench_mrr.py)
against scripts/bench_mrr.py.

The Config is held field for field against the one the JAX script builds,
at its defaults and under each knob, with the graph scale.  Then the JAX
script itself runs on a citation2 stand-in at scale 0.005 with each split
cut to 64 sources and the reference's 1,000 negatives a source, at testbs
16,384 (so the dual-K split of an eval split engages); the port's
functions run the same program from the same initial parameters
(weights.params_from_jax).  The cut splits, their negatives and the scored
links are held equal as arrays; valid and test MRR at rtol 1e-4: eval has
no dropout, the stand-in's A^2 packs at this scale, so the ELL tables (both
built from ``default_rng(1)``) freeze every capped row's window, and the
bfloat16 default reaches only the node features, which both packages round
alike (the tolerance of the bfloat16 trajectories in
tests/test_torch_trainer.py)."""
import contextlib
import dataclasses
import io
import os
import re
import sys

import jax
import numpy as np
import pytest

from ocn_tpu_torch.scripts import bench_mrr as TM
from ocn_tpu_torch.weights import params_from_jax
from torch_parity import _JitInit, native_route, one_thread  # noqa: F401 (autouse fixtures)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import bench_mrr as JM  # noqa: E402

KNOBS = ("OCN_BENCH_SCALE", "OCN_BENCH_MRR_CAP", "OCN_BENCH_TESTBS",
         "OCN_BENCH_ADJ2CAP", "OCN_BENCH_PLATFORM")
TINY = dict(OCN_BENCH_SCALE="0.005", OCN_BENCH_MRR_CAP="64",
            OCN_BENCH_TESTBS="16384")


@pytest.fixture
def knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)

    def set_knobs(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return set_knobs


class _Stop(Exception):
    pass


def jax_program(monkeypatch, run=False):
    """Run scripts/bench_mrr.py's main and return what it built: the Config
    and the dataset scale; with ``run`` the whole program, also its cut
    dataset, its initial state and its printed line.  Without it the
    dataset is a small stand-in and the trainer's construction stops the
    program."""
    import ocn_tpu.data.loaders as jloaders
    import ocn_tpu.train.loop as jloop

    seen = {}
    synthetic = jloaders.synthetic_dataset

    def dataset(name, seed=0, scale=1.0):
        seen["scale"] = scale
        return synthetic(name, seed=seed, scale=scale if run else 0.001)

    class Trainer(jloop.Trainer):
        def __init__(self, cfg, ds):
            seen["cfg"] = dataclasses.replace(cfg)
            if not run:
                raise _Stop
            seen["ds"] = ds
            super().__init__(cfg, ds)
            self.predictor = _JitInit(self.predictor)

        def init_state(self, seed):
            seen["state"] = super().init_state(seed)
            return seen["state"]

        def evaluate_mrr(self, state):
            seen["mrr"] = super().evaluate_mrr(state)
            return seen["mrr"]

    monkeypatch.setattr(jloaders, "synthetic_dataset", dataset)
    monkeypatch.setattr(jloop, "Trainer", Trainer)
    if run:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            JM.main()
        seen["line"] = out.getvalue().strip()
    else:
        with pytest.raises(_Stop):
            JM.main()
    return seen


@pytest.mark.parametrize("env", [
    {}, {"OCN_BENCH_TESTBS": "32768", "OCN_BENCH_ADJ2CAP": "256"},
    {"OCN_BENCH_SCALE": "0.5", "OCN_BENCH_MRR_CAP": "100"},
], ids=["defaults", "testbs_adj2cap", "scale_cap"])
def test_config_equals_jax(knobs, monkeypatch, env):
    knobs(**env)
    want = jax_program(monkeypatch)
    scale, cap, testbs, adj2_cap = TM.mrr_knobs()
    assert dataclasses.asdict(TM.mrr_config(testbs, adj2_cap)) == \
        dataclasses.asdict(want["cfg"])
    assert scale == want["scale"] == float(env.get("OCN_BENCH_SCALE", "0.25"))
    assert cap == int(env.get("OCN_BENCH_MRR_CAP", "8192"))


@pytest.fixture(scope="module")
def mrr():
    """The JAX script's run and the port's on the TINY knobs."""
    mp = pytest.MonkeyPatch()
    try:
        for k in KNOBS:
            mp.delenv(k, raising=False)
        for k, v in TINY.items():
            mp.setenv(k, v)
        want = jax_program(mp, run=True)
        scale, cap, testbs, adj2_cap = TM.mrr_knobs()
    finally:
        mp.undo()
    ds, n_scored = TM.mrr_dataset(scale, cap)
    tr, state = TM.setup(TM.mrr_config(testbs, adj2_cap), ds, "cpu")
    js = jax.device_get(want["state"])
    params_from_jax(js.params, js.ema, state.encoder, state.predictor)
    dt, out = TM.run(tr, state)
    return want, tr, n_scored, out, TM.mrr_line(scale, ds.n_nodes, n_scored, dt, out)


def test_cut_splits_and_negatives_equal_jax(mrr):
    want, tr, n_scored, _, _ = mrr
    jds = want["ds"]
    assert tr.ds.n_nodes == jds.n_nodes
    for part in ("valid", "test"):
        for k in ("source_node", "target_node", "target_node_neg"):
            np.testing.assert_array_equal(tr.ds.split_edge[part][k],
                                          jds.split_edge[part][k])
        assert jds.split_edge[part]["target_node_neg"].shape == (64, 1000)
    assert n_scored == 2 * 64 * 1001
    # the tables are on at this scale, and the splits are longer than testbs
    assert tr._use_ell and 64 * 1000 > tr.cfg.testbs


def test_mrr_equals_jax(mrr):
    want, _, n_scored, out, line = mrr
    assert set(out) == {"valid", "test"}
    for part in ("valid", "test"):
        np.testing.assert_allclose(out[part], want["mrr"][part], rtol=1e-4)
        assert 0 < out[part] <= 1
    # the JAX script's line, but for the time, the rate and the MRR values
    timed = r"[0-9.]+ s -> [0-9,]+ links/s; MRR .*"
    assert re.sub(timed, "", line) == re.sub(timed, "", want["line"])
    assert f"{n_scored:,} scored links" in line

"""Port parity: the eval-path instrument (ocn_tpu_torch/scripts/
bench_eval.py) against scripts/bench_eval.py.

The Config is held field for field against the one the JAX script builds,
at its defaults and under each knob.  Then the JAX script itself runs on
synthetic collab at scale 0.01 (its dataset call redirected there) with
its Config narrowed to hidden 32 and 1 layer, and its frame widths set
above the stand-in's degrees: without the tables (the ell=0 arm) a row over
its width is a window that each package samples from its own stream, and
one such row moves every score of its batch through the column sums.  The
port's functions run the same narrowed program from the same initial
parameters (weights.params_from_jax) and the same ``default_rng(1)`` ELL
tables, toggling the three arms on one live Trainer as the script does.
Each arm's scores (every ``_score_split`` of the timed evaluate: train,
valid and test) are held against JAX's at rtol 1e-4 (atol 1e-6), and its
Hits@K are JAX's metric of them: eval has no dropout, and the default's bfloat16 reaches only the
node features, which both packages round alike (the tolerance of the
bfloat16 trajectories in tests/test_torch_trainer.py).  The dual-K split
still engages (sources of degree <= k_small 16 score at width 16)."""
import contextlib
import dataclasses
import io
import os
import re
import sys

import jax
import numpy as np
import pytest

from ocn_tpu_torch.scripts import bench_eval as TE
from ocn_tpu_torch.weights import params_from_jax
from torch_parity import _JitInit, native_route, one_thread  # noqa: F401 (autouse fixtures)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import bench_eval as JE  # noqa: E402

KNOBS = ("OCN_BENCH_BATCH", "OCN_BENCH_PREDICTOR", "OCN_BENCH_RECK",
         "OCN_BENCH_PLATFORM")
SCALE = 0.01
# hidden 32 and 1 layer; the frame widths above the stand-in's degrees
# (122 and, in A^2, 726)
NARROW = dict(hiddim=32, mplayers=1, pad_deg=128, pad_deg2=768)
TINY_BATCH = "1024"


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
    """Run scripts/bench_eval.py's main and return what it built: the
    Config and the dataset scale; with ``run`` the whole program on collab
    at SCALE with the Config narrowed, also the dataset, the initial state,
    every ``_score_split`` result in call order and the printed lines.
    Without it the trainer's construction stops the program."""
    import ocn_tpu.data.loaders as jloaders
    import ocn_tpu.train.loop as jloop

    seen = {"scores": []}
    synthetic = jloaders.synthetic_dataset

    def dataset(name, seed=0, scale=1.0):
        seen["scale"] = scale
        return synthetic(name, seed=seed, scale=SCALE if run else 0.001)

    class Trainer(jloop.Trainer):
        def __init__(self, cfg, ds):
            seen["cfg"] = dataclasses.replace(cfg)
            if not run:
                raise _Stop
            for k, v in NARROW.items():
                setattr(cfg, k, v)
            seen["ds"] = ds
            super().__init__(cfg, ds)
            self.predictor = _JitInit(self.predictor)

        def init_state(self, seed):
            seen["state"] = super().init_state(seed)
            return seen["state"]

        def _score_split(self, *args, **kw):
            out = super()._score_split(*args, **kw)
            seen["scores"].append(np.asarray(out))
            return out

    monkeypatch.setattr(jloaders, "synthetic_dataset", dataset)
    monkeypatch.setattr(jloop, "Trainer", Trainer)
    if run:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            JE.main()
        seen["lines"] = out.getvalue().splitlines()
    else:
        with pytest.raises(_Stop):
            JE.main()
    return seen


@pytest.mark.parametrize("env", [
    {}, {"OCN_BENCH_BATCH": "16384"},
    {"OCN_BENCH_PREDICTOR": "cn2", "OCN_BENCH_RECK": "16"},
    {"OCN_BENCH_PREDICTOR": "cn6"},
], ids=["defaults", "batch", "cn2_reck16", "cn6"])
def test_config_equals_jax(knobs, monkeypatch, env):
    knobs(**env)
    want = jax_program(monkeypatch)
    cfg = TE.eval_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want["cfg"])
    assert want["scale"] == 1.0


@pytest.fixture(scope="module")
def arms():
    """The JAX script's run and the port's, at SCALE with the narrowed
    Config; returns (JAX record, port's lines, port's scores a call, the
    port's results a arm, n_eval)."""
    mp = pytest.MonkeyPatch()
    try:
        for k in KNOBS:
            mp.delenv(k, raising=False)
        mp.setenv("OCN_BENCH_BATCH", TINY_BATCH)
        want = jax_program(mp, run=True)
        cfg = dataclasses.replace(TE.eval_config(), **NARROW)
    finally:
        mp.undo()
    ds = TE.eval_dataset(SCALE)
    tr, state = TE.setup(cfg, ds, "cpu")
    js = jax.device_get(want["state"])
    params_from_jax(js.params, js.ema, state.encoder, state.predictor)
    scores, results = [], []
    score_split = tr._score_split

    def recorded(*args, **kw):
        out = score_split(*args, **kw)
        scores.append(out)
        return out

    tr._score_split = recorded
    n = TE.n_eval(ds)
    lines = []
    for label, ell, dual in TE.ARMS:
        dt, res = TE.run_arm(tr, state, ell, dual)
        lines.append(TE.arm_line(label, dt, n, res))
        results.append(res)
    return want, lines, scores, results, n, tr


def test_dataset_and_n_eval_equal_jax(arms):
    want, lines, _, _, n, tr = arms
    jds = want["ds"]
    assert tr.ds.n_nodes == jds.n_nodes
    for part, d in jds.split_edge.items():
        for k, v in d.items():
            np.testing.assert_array_equal(tr.ds.split_edge[part][k], v)
    assert n == sum(len(v) for d in jds.split_edge.values() for v in d.values())
    # the levers engage: ELL tables, and splits longer than testbs (the
    # dual-K split of an eval split needs more than one batch)
    assert tr._use_ell
    assert len(jds.split_edge["train"]["edge"]) > int(TINY_BATCH)


@pytest.mark.parametrize("arm", range(3), ids=[a[0] for a in TE.ARMS])
def test_arm_scores_and_lines_equal_jax(arms, arm):
    want, lines, scores, results, n, tr = arms
    # 5 splits an evaluate, warm then timed; the timed one is compared
    per_eval = 5
    assert len(scores) == len(want["scores"]) == 2 * per_eval * len(TE.ARMS)
    start = (2 * arm + 1) * per_eval
    got, jgot = scores[start:start + per_eval], want["scores"][start:start + per_eval]
    for i in range(per_eval):
        np.testing.assert_allclose(got[i], jgot[i], rtol=1e-4, atol=1e-6,
                                   err_msg=f"split {i}")
    # the warm evaluate scores as the timed one
    for a, b in zip(scores[start - per_eval:start], got):
        np.testing.assert_array_equal(a, b)
    # the JAX script's line, but for the two times and the Hits (from
    # scores within rtol 1e-4, a rank can swap at the threshold)
    timed = r"[0-9.]+ s for (.*) -> [0-9,]+ edges/s \(Hits@50: .*"
    assert (re.sub(timed, r"\1", lines[arm])
            == re.sub(timed, r"\1", want["lines"][arm]))
    assert f"for ~{n} scored edges -> " in lines[arm]
    assert lines[arm].endswith(f"(Hits@50: {results[arm]['Hits@50']})")


def test_arm_hits_equal_jax_metric(arms):
    """Each arm's Hits@K (train, valid, test) are JAX's metric of the
    port's scores, exactly; their scores are held against JAX's above."""
    from ocn_tpu.train import metrics as JM

    _, _, scores, results, _, _ = arms
    for arm, res in enumerate(results):
        s = scores[(2 * arm + 1) * 5:(2 * arm + 2) * 5]
        for k in (20, 50, 100):
            assert res[f"Hits@{k}"] == (JM.hits_at_k(s[0], s[2], k),
                                        JM.hits_at_k(s[1], s[2], k),
                                        JM.hits_at_k(s[3], s[4], k))

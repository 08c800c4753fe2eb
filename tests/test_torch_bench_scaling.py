"""Port parity: the weak-scaling harness (ocn_tpu_torch/scripts/
bench_scaling.py) against scripts/bench_scaling.py.

What both build is held equal: the Config of every mode at every dp, field
for field, and the batch, its negatives and its mask positions, captured
from the JAX script's own loop (its steps replaced by ones that record
their inputs).  Then one step's loss of each mode at dp 1 and 2 on gloo
ranks on the CPU (spawned once a dp for the module, running the script's
Config, inputs and step in tests/torch_dist.py scaling_case) against JAX's
step on conftest's eight virtual devices, from
the same initial parameters (weights.params_from_jax): every dropout 0 and
the frame widths above the graph's degrees (pad_deg 64 >= 62, pad_deg2 320
>= 308 on Cora at scale 1.0), so that no random stream is read; rtol 1e-4,
as tests/test_torch_dist.py holds the DP step."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ocn_tpu.config import Config as JConfig
from ocn_tpu.train.loop import Trainer as JTrainer
from ocn_tpu_torch.parallel.launch import launch
from ocn_tpu_torch.scripts import bench_scaling as TS
from ocn_tpu_torch.train.loop import Trainer as TTrainer
from ocn_tpu_torch.weights import params_from_jax
import torch_dist as TD
from torch_parity import _JitInit, native_route, one_thread  # noqa: F401 (autouse fixtures)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import bench_scaling as JS  # noqa: E402

PER_DEV = 128
DETERMINISTIC = dict(gnndp=0.0, xdp=0.0, tdp=0.0, gnnedp=0.0, predp=0.0,
                     preedp=0.0, pad_deg=64, pad_deg2=320)


@pytest.fixture
def knobs(monkeypatch):
    for k in ("S_PERDEV", "S_MODE", "S_TPU"):
        monkeypatch.delenv(k, raising=False)

    def set_knobs(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return set_knobs


def jax_program(monkeypatch, mode):
    """Run scripts/bench_scaling.py's main for ``mode`` with its steps
    replaced by recorders; returns {dp: {"cfg", "inputs"}}: the Config of
    each dp and the (pos, neg, mask positions) its step was given (for
    sharded_prod the prepare_batch arguments (pos, neg, idx))."""
    import ocn_tpu.parallel.sharded_graph as jsg
    import ocn_tpu.parallel.spmd as jspmd
    import ocn_tpu.train.loop as jloop

    seen = {}
    per_dev = int(os.environ.get("S_PERDEV", "512"))

    class Trainer(jloop.Trainer):
        def __init__(self, cfg, ds):
            super().__init__(cfg, ds)
            seen["now"] = seen[cfg.batch_size // per_dev] = {"cfg": cfg}
            self.train_step = self.record_step  # __init__ binds the jitted step

        def init_state(self, seed):
            return None

        def prepare_batch(self, pos_b, neg_b, idx=None):
            seen["now"]["inputs"] = (pos_b, neg_b, idx)
            return None, None, None, None, None

        def record_step(self, state, *args):
            return state, jnp.float32(1.0)

    def spmd_step(tr, mesh):
        def step(state, pe, ne, mp, key):
            seen["now"]["inputs"] = tuple(np.asarray(a) for a in (pe, ne, mp))
            return state, jnp.float32(1.0)
        return step

    def sharded_step(tr, mesh):
        return spmd_step(tr, mesh), lambda mp: mp

    monkeypatch.setenv("S_MODE", mode)
    monkeypatch.setattr(jloop, "Trainer", Trainer)
    monkeypatch.setattr(jspmd, "make_spmd_train_step", spmd_step)
    monkeypatch.setattr(jsg, "make_sharded_graph_train_step", sharded_step)
    JS.main()
    del seen["now"]
    return seen


@pytest.mark.parametrize("mode", TS.MODES)
@pytest.mark.parametrize("per_dev", [None, str(PER_DEV)])
def test_configs_and_inputs_equal_jax(knobs, monkeypatch, capsys, mode, per_dev):
    """Every dp of the JAX loop (1, 2, 4, 8 on conftest's eight devices):
    the Config field for field, and the step's inputs as equal arrays."""
    if per_dev:
        knobs(S_PERDEV=per_dev)
    pd = int(per_dev or 512)
    want = jax_program(monkeypatch, mode)
    assert sorted(want) == list(TS.DPS)
    # the JAX loop's lines, one a dp, as the port prints them
    assert len(capsys.readouterr().out.splitlines()) == len(TS.DPS)
    ds = TS.scaling_dataset()
    for dp in TS.DPS:
        cfg = TS.scaling_config(mode, dp, pd)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[dp]["cfg"])
        tr = TTrainer(dataclasses.replace(cfg, dp_devices=1), ds, device="cpu")
        pos_b, neg, idx, mp = TS.scaling_inputs(ds, cfg.batch_size, tr.edge2pos)
        got = (pos_b, neg, idx) if mode == "sharded_prod" else (pos_b, neg, mp)
        for a, b in zip(got, want[dp]["inputs"]):
            np.testing.assert_array_equal(a, np.asarray(b))


def _jax_loss(mode, dp, cfg, jt, js, pos_b, neg, idx, mp):
    """The JAX script's first step of ``mode`` at ``dp`` on trainer ``jt``
    from state ``js``."""
    from ocn_tpu.parallel.mesh import make_mesh
    from ocn_tpu.parallel.sharded_graph import make_sharded_graph_train_step
    from ocn_tpu.parallel.spmd import make_spmd_train_step

    key = jax.random.PRNGKey(0)
    if mode == "sharded_prod":
        if jt._use_ell:
            jt._refresh_ell(np.random.default_rng(1))
        pe, ne, m, ip, inn = jt.prepare_batch(pos_b, neg, idx)
        return float(jt.train_step(js, pe, ne, m, key, ip, inn)[1])
    mesh = make_mesh(dp=dp, tp=1)
    if mode == "sharded":
        step, prepare = make_sharded_graph_train_step(jt, mesh)
        return float(step(js, jnp.asarray(pos_b), jnp.asarray(neg),
                          prepare(mp), key)[1])
    step = make_spmd_train_step(jt, mesh)
    return float(step(js, jnp.asarray(pos_b), jnp.asarray(neg), jnp.asarray(mp),
                      key)[1])


@pytest.fixture(scope="module")
def first_losses():
    """{dp: (JAX's loss by mode, every rank's result)} at dp 1 and 2, both
    packages from JAX's initial parameters of each mode's Config."""
    ds = TS.scaling_dataset()
    from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic

    jds = jsynthetic("Cora", seed=0, scale=1.0)
    out = {}
    for dp in (1, 2):
        want, init = {}, {}
        for mode in TS.MODES:
            cfg = dataclasses.replace(TS.scaling_config(mode, dp, PER_DEV),
                                      **DETERMINISTIC)
            jt = JTrainer(JConfig(**dataclasses.asdict(cfg)), jds)
            jt.predictor = _JitInit(jt.predictor)
            js = jt.init_state(0)
            # one device here: only the initial parameters are taken
            tt = TTrainer(dataclasses.replace(cfg, dp_devices=1), ds, device="cpu")
            ts = tt.init_state(0)
            params_from_jax(*jax.device_get((js.params, js.ema)), ts.encoder,
                            ts.predictor, jax.device_get(js.sched))
            init[mode] = {"encoder": ts.encoder.state_dict(),
                          "predictor": ts.predictor.state_dict()}
            pos_b, neg, idx, mp = TS.scaling_inputs(ds, cfg.batch_size, tt.edge2pos)
            want[mode] = _jax_loss(mode, dp, cfg, jt, js, pos_b, neg, idx, mp)
        ranks = launch(TD.scaling_case, dp, dp, PER_DEV, DETERMINISTIC, init,
                       device="cpu", threads=1)
        out[dp] = (want, ranks)
    return out


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("mode", TS.MODES)
def test_first_step_loss_equals_jax(first_losses, dp, mode):
    want, ranks = first_losses[dp]
    assert len(ranks) == dp
    for r in ranks:
        np.testing.assert_allclose(r[mode], want[mode], rtol=1e-4)
    # every rank reads the same loss
    assert len({r[mode] for r in ranks}) == 1


def test_rows_and_line():
    """Efficiency against dp 1 from the slowest rank's time, and the JAX
    script's line."""
    by_dp = {1: [{"spmd": {"ms": 10.0}}],
             2: [{"spmd": {"ms": 12.0}}, {"spmd": {"ms": 20.0}}]}
    r1, r2 = TS.rows("spmd", 512, by_dp)
    assert (r1["batch"], r1["edges_per_s"], r1["efficiency"]) == (512, 102400.0, 1.0)
    assert (r2["ms"], r2["edges_per_s"], r2["efficiency"]) == (20.0, 102400.0, 0.5)
    assert TS.scaling_line(2, 1024, 20.0, 102400.0, 0.5) == (
        "dp=2 batch=1024: 20.0 ms/step -> 102400 edges/s (weak-scaling eff 50%)")

"""Parity of the port's cn3 (the incomplete family's higher-order predictor,
IncompleteCNPredictor(higher_order=True)) against the JAX package on the
CPU: forward, gradients and EMA at depth 1 and 2, the blocked recursion
scorer against JAX's and against the port's own generic route, and a
trainer trajectory.  Deterministic settings as in
tests/test_torch_incomplete.py (cn2, and the family's shared pieces)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.nn.predictors.cn_incomplete import IncompleteCNPredictor as JIncomplete
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from torch_parity import FAMILY_KW as BASE
from torch_parity import TOL, family_pair, family_sequence, family_setup, trajectory
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)


@pytest.fixture(scope="module")
def cora():
    return family_setup()


@pytest.mark.parametrize("kw,modes,k,steps", [
    (dict(depth=1, rec_k=8), (True, True), 8, 5),
    (dict(depth=2, learnpt=True, rec_k=16, cndeg=12, trndeg=6, tstdeg=6),
     (True,), None, 21),
], ids=["d1-k8", "d2-learnpt-cndeg-trndeg6"])
def test_cn3_forward_and_ema_match_jax(cora, kw, modes, k, steps):
    # cn3 steps its EMA on the outer call and on each of its four recursive
    # calls, in the JAX package's order: 1 + 4 at depth 1, 1 + 4 * 5 at
    # depth 2.  The outer width 8 leaves the A^2 row at the full 16 (the
    # blocked route); cndeg samples cn and cn22 apart from the src frame and
    # sends every level down the generic route, trndeg 6 caps residual rows
    # (strided lanes: no sample stream on either side)
    tp, ema = family_sequence("cn3", cora, dict(BASE, **kw), modes, k)
    assert tp.higher_order
    assert int(ema["n"]) == 3 + steps * len(modes)


def test_blocked_depth0_matches_jax_and_generic(cora):
    jp, v, tp = family_pair("cn3", cora, **dict(BASE, rec_k=8))
    rng = np.random.default_rng(4)
    b, r, n = 20, 5, cora["n"]
    anchors = rng.integers(0, n, size=b)
    cand = rng.integers(0, n, size=(b, r))
    cand[::4, -1] = n  # padded candidates carry the sentinel id
    valid = cand < n
    want, upd = jax.jit(lambda x, a, c, m: jp.apply(
        v, x, cora["jg"], a, c, True, cora["ja2"], valid=m,
        method=JIncomplete._blocked_depth0, mutable=["ema"]))(
            jnp.asarray(cora["x"]), jnp.asarray(anchors), jnp.asarray(cand),
            jnp.asarray(valid))
    x = torch.as_tensor(cora["x"])
    got = tp._blocked_depth0(x, cora["tg"], torch.as_tensor(anchors),
                             torch.as_tensor(cand), True, None, None,
                             cora["ta2"], valid=torch.as_tensor(valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(tp.innerprod),
                               float(upd["ema"]["innerprod"]), **TOL)
    assert int(tp.n) == int(upd["ema"]["n"]) == 4
    # the generic route over the valid candidates alone gives the same
    # scores, colsums and EMA step included
    tp2 = family_pair("cn3", cora, **dict(BASE, rec_k=8))[2]
    a = torch.as_tensor(anchors)[:, None].expand(b, r)[torch.as_tensor(valid)]
    c = torch.as_tensor(cand)[torch.as_tensor(valid)]
    generic = tp2._forward(x, cora["tg"], torch.stack([a, c]), True, 0, None,
                           None, cora["ta2"])
    np.testing.assert_allclose(got[valid].detach().numpy(),
                               generic.reshape(-1).detach().numpy(),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(float(tp2.innerprod), float(tp.innerprod),
                               rtol=1e-5)


def test_cn3_trajectory_matches_jax():
    # ELL tables of g and A^2 (capped rows frozen from one NumPy seed on both
    # sides), maskinput, learnable pt; the recursion at rec_k 8 (learning
    # rates 1e-3, see tests/torch_parity.py)
    kw = dict(model="gcn", mplayers=1, hiddim=16, ln=True, res=True, jk=True,
              use_xlin=True, tailact=True, lnnn=True, gnndp=0.0, xdp=0.0,
              tdp=0.0, gnnedp=0.0, predp=0.0, preedp=0.0, gnnlr=0.001,
              prelr=0.001, ell_tables=True, k_small=0, maskinput=True,
              batch_size=64, linkbatchsize=16, testbs=64, pad_deg=16,
              pad_deg2=16, trndeg=16, tstdeg=16, depth=1, rec_k=8,
              probscale=4.3, proboffset=2.8, pt=0.75, learnpt=True,
              predictor="cn3")
    jt, _, tt, ts = trajectory(kw, jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs(),
                               tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs(),
                               nsteps=3)
    assert tt.adj2 is not None and "tbl2" in tt._ell and tt._use_ell
    assert int(ts.predictor.n) > 0


@pytest.mark.parametrize("pred", ["cn3", "cn4"])
def test_cli_drives_the_family(pred, capsys):
    # the family's flags reach the trainer: rec_k -1 is tuned from the
    # graph, increasealpha ramps alpha2 (0 before epoch 6)
    from ocn_tpu_torch import cli as tcli

    cfg = tcli.parseargs([
        "--dataset", "Cora", "--predictor", pred, "--model", "puregcn",
        "--mplayers", "1", "--hiddim", "16", "--batch_size", "128",
        "--testbs", "256", "--epochs", "1", "--runs", "1", "--maskinput",
        "--pad_deg", "16", "--pad_deg2", "16", "--synthetic_scale", "0.1",
        "--ell_tables", "--k_small", "4", "--rec_k", "-1", "--depth", "1",
        "--learnpt", "--increasealpha", "--platform", "cpu"])
    assert (cfg.predictor, cfg.rec_k, cfg.learnpt, cfg.increasealpha) == (
        pred, -1, True, True)
    summary = tcli.run(cfg)
    out = capsys.readouterr().out
    assert "Final result: val" in out and out.count("Hits@50  Run: 01") == 1
    assert cfg.rec_k in (8, 16) and 0.0 <= summary["val_mean"] <= 1.0

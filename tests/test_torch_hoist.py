"""Port parity: hoisted frames (Config.hoist_frames), the JAX package's
_scan_scores_hoisted.  In the port they are one frame group of every chunk
of the step: one cn_frames call builds the frames of all 2*batch_size
links (two membership lookups a step, at 2*batch_size rows), then the
predictor runs chunk by chunk, so column sums and the EMA stay per chunk.
Hoisting turns the dual-K split off (k_small is set and ignored); eval is
never hoisted.  Five steps, an epoch and evaluate against the JAX Trainer
at rtol 1e-4 (learning rates 1e-3, as in tests/test_torch_cn6.py)."""
import pytest

from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu_torch.config import Config as TConfig
from ocn_tpu_torch.config import require_supported
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.ops import frame as tf
from torch_parity import trajectory
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

KW = dict(model="gcn", mplayers=2, hiddim=16, ln=True, res=True, jk=True,
          use_xlin=True, tailact=True, lnnn=True, gnndp=0.0, xdp=0.0, tdp=0.0,
          gnnedp=0.0, predp=0.0, preedp=0.0, gnnlr=0.001, prelr=0.001,
          ell_tables=True, k_small=4, maskinput=True, batch_size=64,
          linkbatchsize=16, testbs=64, pad_deg=16, pad_deg2=8,
          hoist_frames=True, frame_group=2)


@pytest.fixture(scope="module")
def cora():
    return (jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs(),
            tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs())


@pytest.mark.parametrize("kw", [
    dict(predictor="cn5", window_table=True),
    dict(predictor="cn7", sum=27.29),
], ids=["cn5-window", "cn7"])
def test_hoisted_trajectory_matches_jax(cora, monkeypatch, kw):
    kw = dict(KW, **kw)
    require_supported(TConfig(**kw))
    shapes = []
    real = tf.membership_counts

    def counting(q, ids, w):
        shapes.append((q.shape[0], q.shape[1], ids.shape[1]))
        return real(q, ids, w)

    monkeypatch.setattr(tf, "membership_counts", counting)
    per_step = []

    def on_step(tt):
        per_step.append(list(shapes))
        shapes.clear()

    jt, _, tt, ts = trajectory(kw, *cora, on_step=on_step)
    assert tt._split is None and jt._split is None
    # cn1 and cn2 of all 2*batch links: N(i) at pad_deg against N(j) and
    # the A^2 row at pad_deg2
    rows = 2 * kw["batch_size"]
    assert per_step == [[(rows, 16, 8), (rows, 16, 8)]] * 5

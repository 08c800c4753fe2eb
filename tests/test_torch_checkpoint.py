"""Port parity: checkpoints (ocn_tpu_torch/train/checkpoint.py), the JAX
TrainState carried across whole (weights.py state_from_jax: parameters,
EMA, sched and the optax Adam state), and embedding files shared by both
packages."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.train import checkpoint as jckpt
from ocn_tpu_torch.config import Config as TConfig
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.train import checkpoint as tckpt
from ocn_tpu_torch.train.loop import Trainer as TTrainer
from ocn_tpu_torch.weights import adam_groups, params_from_jax, state_from_jax
from torch_parity import trainer_pair
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

# the incomplete family's cn2 on ELL tables: parameters, the EMA buffers
# and alpha2 (sched) all in the state
FAMILY = dict(predictor="cn2", model="gcn", mplayers=1, hiddim=16, ln=True,
              res=True, jk=True, use_xlin=True, tailact=True, gnndp=0.1,
              predp=0.1, gnnlr=0.001, prelr=0.001, ell_tables=True, k_small=0,
              maskinput=True, batch_size=64, linkbatchsize=16, testbs=64,
              pad_deg=16, pad_deg2=8, trndeg=16, tstdeg=16, depth=1, rec_k=8)
# cn5 with every dropout 0 and no capped row: no random stream is read
CN5 = dict(model="gcn", mplayers=2, hiddim=16, ln=True, res=True, jk=True,
           use_xlin=True, tailact=True, lnnn=True, gnndp=0.0, xdp=0.0, tdp=0.0,
           gnnedp=0.0, predp=0.0, preedp=0.0, gnnlr=0.001, prelr=0.001,
           ell_tables=False, k_small=0, maskinput=True, batch_size=64,
           linkbatchsize=32, testbs=64, pad_deg=32, pad_deg2=96)


def _tensors(state):
    out = {f"encoder.{k}": v.clone() for k, v in state.encoder.state_dict().items()}
    out.update({f"predictor.{k}": v.clone()
                for k, v in state.predictor.state_dict().items()})
    for i, (p, st) in enumerate(state.opt.state.items()):
        out.update({f"opt.{i}.{k}": v.clone() for k, v in st.items()})
    return out


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _steps(tr, state, idxs, seed):
    pos = tr.train_edges
    neg = np.random.default_rng(seed).integers(0, tr.ds.n_nodes, size=pos.shape)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for idx in idxs:
        inputs = tr.prepare_batch(pos[:, idx], neg[:, idx], idx)
        state, loss = tr.train_step(state, *inputs[:3], gen, *inputs[3:])
        losses.append(float(loss))
    return state, losses


def test_round_trip_is_bit_exact(tmp_path):
    ds = tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs()
    tr = TTrainer(TConfig(**FAMILY), ds, device="cpu")
    tr._refresh_ell(np.random.default_rng(1))
    state = tr.init_state(0)
    batches = [np.arange(i * 64, (i + 1) * 64) for i in range(4)]
    state, _ = _steps(tr, state, batches[:2], 0)
    state.sched["alpha2"].fill_(0.3)  # an alpha ramp
    tckpt.save_state(str(tmp_path), state, 2)
    at2 = _tensors(state)
    state, _ = _steps(tr, state, batches[2:3], 1)
    tckpt.save_state(str(tmp_path), state, 3)
    at3 = _tensors(state)
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    assert any(k.startswith("opt.") and k.endswith("exp_avg_sq") for k in at3)
    assert float(at3["predictor.alpha2"]) == pytest.approx(0.3)

    restored, step = tckpt.load_state(str(tmp_path), tr.init_state(7))
    assert step == 3
    _equal(_tensors(restored), at3)
    older, step = tckpt.load_state(str(tmp_path), tr.init_state(8), step=2)
    assert step == 2
    _equal(_tensors(older), at2)
    # the restored state steps exactly as the saved one does
    _, want = _steps(tr, state, batches[3:], 5)
    _, got = _steps(tr, restored, batches[3:], 5)
    assert got == want
    _equal(_tensors(restored), _tensors(state))


@pytest.fixture(scope="module")
def cora_pair():
    return (jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs(),
            tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs())


def test_jax_state_continues_in_the_port(cora_pair):
    """One JAX epoch, the whole state carried across, then epoch 2 on both
    sides from one NumPy seed: the same loss (rtol 1e-4).  The same epoch
    from the JAX parameters alone, with a fresh Adam, is off."""
    jt, js, tt, _ = trainer_pair(CN5, *cora_pair)
    assert int(tt.g.deg.max()) <= CN5["pad_deg"]
    js, _ = jt.train_epoch(js, np.random.default_rng(3), 1)
    host = jax.device_get(js)
    groups = adam_groups(host.opt_state)
    count = int(groups["encoder"]["count"])
    assert count == int(groups["predictor"]["count"]) > 1

    ts = state_from_jax(host, tt.init_state(5))
    params_only = tt.init_state(5)
    params_from_jax(host.params, host.ema, params_only.encoder,
                    params_only.predictor)
    # layouts: a Dense kernel's moments transposed like its weight
    lin = ts.encoder.convs[0].lin.weight
    st = ts.opt.state[lin]
    mu = groups["encoder"]["mu"]["GCNConvLike_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(mu).T)
    assert float(st["step"]) == count
    assert set(ts.opt.state) == set(p for g in ts.opt.param_groups for p in g["params"])

    js, jloss = jt.train_epoch(js, np.random.default_rng(4), 2)
    ts, tloss = tt.train_epoch(ts, np.random.default_rng(4), 2)
    _, floss = tt.train_epoch(params_only, np.random.default_rng(4), 2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert abs(floss - jloss) > 1e-3 * abs(jloss)
    np.testing.assert_allclose(float(ts.predictor.innerprod),
                               float(jax.device_get(js.ema)["innerprod"]), rtol=1e-4)


def test_embeddings_load_in_either_package(tmp_path):
    h = np.random.default_rng(0).standard_normal((50, 8)).astype(np.float32)
    jpath, tpath = str(tmp_path / "j" / "h.npy"), str(tmp_path / "t" / "h.npy")
    jckpt.save_embeddings(jpath, jnp.asarray(h))
    got = tckpt.load_embeddings(jpath)
    np.testing.assert_array_equal(got, h)
    assert got.dtype == np.float32
    tckpt.save_embeddings(tpath, torch.as_tensor(h))
    np.testing.assert_array_equal(jckpt.load_embeddings(tpath), h)
    tckpt.save_embeddings(tpath, torch.as_tensor(h).bfloat16())
    assert tckpt.load_embeddings(tpath).dtype == np.float32


def test_load_without_a_checkpoint_raises(tmp_path):
    ds = tsynthetic("Cora", seed=0, scale=0.05)
    tr = TTrainer(TConfig(), ds, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tckpt.load_state(str(tmp_path), tr.init_state(0))

"""Parity of the port's incomplete-CN family, cn2 and cn4 (and its pieces:
sample_frame, lane-mask DropAdj, the residual frames, cndeg on the
frame-based path, the alpha ramp) against the JAX package on the CPU.

Deterministic settings, so that neither side reads a random stream:
dropout 0, DropAdj 0, degrees under the frame widths (or capped rows frozen
in ELL tables whose offsets come from NumPy), and trndeg/tstdeg at least
every residual row's lane count.  The random paths are checked in
expectation, as tests/test_lane_drop.py does for the JAX package.  cn3 is
in tests/test_torch_incomplete_ho.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.config import Config as JConfig
from ocn_tpu.data.loaders import LinkDataset as JLinkDataset
from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.nn.predictors.cn_incomplete import IncompleteCNPredictor as JIncomplete
from ocn_tpu.ops import frame as jf
from ocn_tpu.ops.sample import sample_frame as jsample
from ocn_tpu.train.loop import Trainer as JTrainer
from ocn_tpu_torch.config import Config as TConfig
from ocn_tpu_torch.data.loaders import LinkDataset as TLinkDataset
from ocn_tpu_torch.data.loaders import randomsplit
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.nn.predictors import build_predictor as tbuild
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.ops.sample import sample_frame as tsample
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse import ell as ELL
from ocn_tpu_torch.train.loop import Trainer as TTrainer
from torch_parity import FAMILY_KW as BASE
from torch_parity import (
    HID, TOL, family_pair, family_sequence, family_setup, trajectory)
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)


@pytest.fixture(scope="module")
def cora():
    return family_setup()


def _frame_pair(rng, b, k, n, p_valid=0.6):
    ids = np.sort(rng.integers(0, n, size=(b, k)), axis=1).astype(np.int32)
    val = (rng.random((b, k)) * (rng.random((b, k)) < p_valid)).astype(np.float32)
    val[0] = 0.0  # an empty row
    val[1] = 1.0  # a full row
    ids = np.where(val != 0, ids, n).astype(np.int32)
    return (jf.CNFrame(jnp.asarray(ids), jnp.asarray(val), n),
            tf.CNFrame(torch.as_tensor(ids), torch.as_tensor(val), n))


@pytest.mark.parametrize("r", [1, 3, 6, 12])
def test_sample_frame_strided_matches_jax(r):
    jfr, tfr = _frame_pair(np.random.default_rng(r), 40, 10, 50)
    want = jsample(jfr, r, None)
    got = tsample(tfr, r, None)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))


def test_sample_frame_random_is_unbiased():
    # E[sum of the sampled values at an id] == the frame's value there;
    # rows at or under r keep their lanes (compacted, weight 1)
    rng = np.random.default_rng(4)
    b, k, n, r, draws = 12, 10, 30, 3, 4000
    _, tfr = _frame_pair(rng, b, k, n)
    rep = tf.CNFrame(tfr.ids.repeat(draws, 1), tfr.val.repeat(draws, 1), n)
    gen = torch.Generator().manual_seed(0)
    got = tsample(rep, r, gen)
    assert got.ids.shape == (b * draws, r)
    assert bool((got.ids[:, 1:] >= got.ids[:, :-1]).all())

    def per_id(frame, rows):
        out = torch.zeros(rows, n + 1)
        return out.scatter_add_(1, frame.ids.long(), frame.val)[:, :n]

    mean = per_id(got, b * draws).reshape(draws, b, n).mean(0)
    want = per_id(tfr, b)
    np.testing.assert_allclose(mean.numpy(), want.numpy(), atol=0.08)
    np.testing.assert_allclose(mean.sum().item(), want.sum().item(), rtol=0.01)
    small = (tfr.val != 0).sum(1) <= r
    strided = tsample(tfr, r, None)
    torch.testing.assert_close(got.val[:b][small], strided.val[small])


def test_lane_drop_is_unbiased_and_keeps_the_graph(cora):
    # E[frame values] under lane masks is the value-mutation DropAdj's
    # marginal (each adjacency entry kept with probability 1-p, kept values
    # / (1-p)): a CN lane survives with its dst lane, E[cn] = (1-p) cn; a
    # lane of N(i) whose dst lane drops joins res1, E[res1] = res1 + p cn,
    # and likewise res2.  k covers every degree, so each id sits in one lane
    # of its row.  The graph's values and ELL table stay as they are.
    tg, p, k = cora["tg"], 0.35, 16
    edges = torch.as_tensor(cora["ds"].split_edge["train"]["edge"][:240].T)
    draws = 1000
    gen = torch.Generator().manual_seed(1)
    val0 = tg.val.clone()
    lane = tf.cn_residual_frames(tg, edges.repeat(1, draws), k, None,
                                 drop=(gen, p))
    assert torch.equal(tg.val, val0)
    cn, res1, res2 = tf.cn_residual_frames(tg, edges, k)
    cn_dst = tf.gather_neighbors(tg, edges[1], k).w - res2.val
    want = ((1 - p) * cn.val, res1.val + p * cn.val, res2.val + p * cn_dst)
    for i, name in enumerate(("cn", "res1", "res2")):
        mean = lane[i].val.reshape(draws, -1, k).mean(0)
        # per lane: about 5 standard errors of a 1,000-draw mean
        np.testing.assert_allclose(mean.numpy(), want[i].numpy(), atol=0.12,
                                   err_msg=name)
        if name != "cn":  # the CN sets hold too few lanes for a 2 % sum
            np.testing.assert_allclose(mean.sum().item(), want[i].sum().item(),
                                       rtol=0.02, err_msg=name)
    # on a table: the kept lanes' ids are the table's, their weights / (1-p)
    off = ELL.draw_offsets(tg.deg.numpy(), 8, np.random.default_rng(3))
    tbl = ELL.build_ell(tg.packed, tg.indptr, torch.as_tensor(off), 8)
    g_ell = tg.with_ell(tbl, torch.as_tensor(off))
    nodes = torch.as_tensor(np.where(tg.deg.numpy() > 8)[0])
    plain = tf.gather_neighbors(g_ell, nodes, 8)
    dropped = tf.gather_neighbors(g_ell, nodes, 8, drop=(gen, 0.3))
    assert torch.equal(dropped.ids, plain.ids)
    kept = dropped.w != 0
    assert kept.any() and (~kept & (plain.w != 0)).any()
    torch.testing.assert_close(dropped.w[kept], plain.w[kept] / 0.7)


@pytest.mark.parametrize("k", [4, 16])
def test_cn_residual_frames_match_jax(cora, k):
    # k 4 caps the rows above it at their first window, deg/k weighted
    tar = cora["tar"]
    want = jf.cn_residual_frames(cora["jg"], jnp.asarray(tar), k, None,
                                 with_src=True)
    got = tf.cn_residual_frames(cora["tg"], torch.as_tensor(tar), k,
                                with_src=True)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.ids.numpy(), np.asarray(b.ids))
        np.testing.assert_array_equal(a.val.numpy(), np.asarray(b.val))
    np.testing.assert_array_equal(got[3].w.numpy(), np.asarray(want[3].w))
    # the residual patterns are disjoint from the CN set on the src frame
    assert not bool(((got[0].val != 0) & (got[1].val != 0)).any())


@pytest.mark.parametrize("name,kw,modes,k", [
    ("cn2", dict(depth=1, rec_k=8), (True, True, False), 8),
    ("cn2", dict(depth=2, learnpt=True, rec_k=16), (True,), None),
    ("cn4", dict(depth=1, cndeg=12, trndeg=6, tstdeg=6), (True,), None),
], ids=["d1-k8", "d2-learnpt", "cn4-d1-cndeg-trndeg6"])
def test_cn2_forward_and_ema_match_jax(cora, name, kw, modes, k):
    # no sample stream on either side: capped rows take their first window
    # (the outer width 8 of the dual-K small body caps some) and capped
    # residual rows (trndeg 6) the strided lanes.  cndeg sends the recursion
    # down the generic route, depth 2 its outer level.
    kw = dict(BASE, **kw)
    tp, ema = family_sequence(name, cora, kw, modes, k)
    assert not tp.higher_order
    # cn2's EMA only decays: 0.75 * 3/4 * 4/5 ... over its training steps,
    # one a call at depth 1 and three at depth 2
    steps = sum(modes) * (3 if kw["depth"] == 2 else 1)
    np.testing.assert_allclose(float(ema["innerprod"]), 0.75 * 3 / (3 + steps),
                               rtol=1e-6)


def test_underflowed_probabilities_keep_gradients_finite(cora):
    # proboffset 100: every clamped probability underflows to 0, so res1,
    # ncn1 and max|ncn1| are 0, and so is the EMA.  The forward matches
    # JAX; the JAX package's where(scale > 0, inner / scale, inner) sends
    # NaN back into the learnable pt, the port's guarded divisor does not
    kw = dict(BASE, learnpt=True, proboffset=100.0, rec_k=8)
    jp, v, tp = family_pair("cn2", cora, **kw)
    v["ema"] = {"innerprod": np.float32(0.0), "n": np.int32(0)}
    tp.innerprod.zero_()
    tp.n.zero_()
    x, tar = jnp.asarray(cora["x"]), jnp.asarray(cora["tar"])

    def jloss(p):
        out = jp.apply({**v, "params": p}, x, cora["jg"], tar, True,
                       mutable=["ema"])[0]
        return jnp.sum(out), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])
    tp.train()
    out = tp(torch.as_tensor(cora["x"]), cora["tg"], torch.as_tensor(cora["tar"]))
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    assert np.isnan(np.asarray(jgrad["ptlin1"]["kernel"])).any()
    for name, p in tp.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), name


def test_blocked_depth0_matches_jax_and_generic(cora, training=True):
    jp, v, tp = family_pair("cn2", cora, **dict(BASE, rec_k=8))
    rng = np.random.default_rng(3)
    b, r, n = 20, 5, cora["n"]
    anchors = rng.integers(0, n, size=b)
    cand = rng.integers(0, n, size=(b, r))
    cand[::4, -1] = n  # padded candidates carry the sentinel id
    valid = cand < n
    want = jax.jit(lambda x, a, c, m: jp.apply(
        v, x, cora["jg"], a, c, training, None, valid=m,
        method=JIncomplete._blocked_depth0))(
            jnp.asarray(cora["x"]), jnp.asarray(anchors), jnp.asarray(cand),
            jnp.asarray(valid))
    x = torch.as_tensor(cora["x"])
    tp.train(training)
    got = tp._blocked_depth0(x, cora["tg"], torch.as_tensor(anchors),
                             torch.as_tensor(cand), training, None, None, None,
                             valid=torch.as_tensor(valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ei = torch.stack([torch.as_tensor(anchors)[:, None].expand(b, r).reshape(-1),
                      torch.as_tensor(np.minimum(cand, n - 1)).reshape(-1)])
    generic = tp._forward(x, cora["tg"], ei, training, 0, None, None).reshape(b, r)
    # the blocked scorer masks padded candidates; the generic one scores
    # them as edges to node n-1
    np.testing.assert_allclose(got[valid].detach().numpy(),
                               generic[valid].detach().numpy(),
                               rtol=2e-5, atol=1e-6)
    assert not valid.all()


def test_blockable_routing(cora):
    tp = tbuild("cn2", HID, HID, **dict(BASE, rec_k=8))
    res = tf.CNFrame(torch.zeros(2 ** 19, 1, dtype=torch.int32),
                     torch.zeros(2 ** 19, 1), cora["n"])
    assert tp._blockable(cora["tg"], res)  # 2^19 * 8 == 2^22
    big = tf.CNFrame(torch.zeros(2 ** 19 + 1, 1, dtype=torch.int32),
                     torch.zeros(2 ** 19 + 1, 1), cora["n"])
    assert not tp._blockable(cora["tg"], big)
    off = torch.zeros(cora["n"], dtype=torch.int64)
    g_ell = cora["tg"].with_ell(
        ELL.build_ell(cora["tg"].packed, cora["tg"].indptr, off, 16), off)
    assert tp._blockable(g_ell, big)
    assert not tbuild("cn2", HID, HID, cndeg=4)._blockable(g_ell, res)


# trainers: ELL tables (capped rows frozen from one NumPy seed on both
# sides), maskinput, residual caps at the frame width; learning rates 1e-3
# (see tests/torch_parity.py).  The dual-K split's routing is held apart
# (test_family_split_and_dual_k_routing_match_jax): its second body would
# double the JAX programs a trajectory compiles
TRAJ = dict(model="gcn", mplayers=1, hiddim=16, ln=True, res=True, jk=True,
            use_xlin=True, tailact=True, lnnn=True, gnndp=0.0, xdp=0.0, tdp=0.0,
            gnnedp=0.0, predp=0.0, preedp=0.0, gnnlr=0.001, prelr=0.001,
            ell_tables=True, k_small=0, maskinput=True, batch_size=64,
            linkbatchsize=16, testbs=64, pad_deg=16, pad_deg2=8, trndeg=16,
            tstdeg=16, depth=1, rec_k=8, probscale=4.3, proboffset=2.8,
            pt=0.75)


@pytest.fixture(scope="module")
def cora_pair():
    return (jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs(),
            tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs())


def test_cn2_trajectory_matches_jax(cora_pair):
    kw = dict(TRAJ, predictor="cn2", learnpt=True)
    jt, _, tt, _ = trajectory(kw, *cora_pair, nsteps=3)
    assert tt.adj2 is None and jt.adj2 is None
    assert tt._use_ell and "tbl2" not in tt._ell


def test_family_split_and_dual_k_routing_match_jax(cora_pair, monkeypatch):
    # the split plan, and which eval edges score at k_small and in what
    # order: both packages' _score_split with their batch scorers replaced
    # by one that tags each edge with its width
    def tag(self, state, h, g, edges, adj2=None, k=None, fold0=0):
        return (k or 0) * 1e7 + edges[:, 0] * 1e4 + edges[:, 1]

    monkeypatch.setattr(JTrainer, "_score_batches", tag)
    monkeypatch.setattr(TTrainer, "_score_batches", tag)
    kw = dict(TRAJ, predictor="cn2", k_small=4, testbs=16, frame_group=2)
    jt = JTrainer(JConfig(**kw), cora_pair[0])
    tt = TTrainer(TConfig(**kw), cora_pair[1], device="cpu")
    assert tt._split == jt._split and tt._split
    edges = tt.train_edges.T
    got = tt._score_split(None, None, tt.g, edges, None)
    np.testing.assert_array_equal(got, jt._score_split(None, None, jt.g, edges))
    small = got >= 4e7
    assert small.any() and not small.all()
    # the rule takes both endpoints: some edges of a low-degree source go big
    deg = tt.g.deg.numpy()
    assert (deg[edges[~small, 0]] <= 4).any()
    assert (np.maximum(deg[edges[small, 0]], deg[edges[small, 1]]) <= 4).all()


def test_rec_k_auto_matches_jax(cora_pair):
    for pad in (16, 64):
        kw = dict(TRAJ, predictor="cn2", rec_k=-1, pad_deg=pad)
        jt = JTrainer(JConfig(**kw), cora_pair[0])
        tt = TTrainer(TConfig(**kw), cora_pair[1], device="cpu")
        assert tt.cfg.rec_k == jt.cfg.rec_k > 0
        assert tt.init_state(0).predictor.rec_k == tt.cfg.rec_k


def _ring_pair(n=120):
    """A circulant graph (i ~ i+1, i+2): every degree is at most 4, so a
    cndeg of 4 caps no CN row."""
    i = np.arange(n)
    und = np.concatenate([np.stack([i, (i + 1) % n]), np.stack([i, (i + 2) % n])], 1)
    ei = B.symmetrize_edge_index(und, n)
    rng = np.random.default_rng(0)
    split = randomsplit(ei, n, rng, val_ratio=0.1, test_ratio=0.2)
    train = B.symmetrize_edge_index(split["train"]["edge"].T, n)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    return tuple(cls(name="ring", x=x, max_x=-1, edge_index=train,
                     split_edge=split, n_nodes=n)
                 for cls in (JLinkDataset, TLinkDataset))


def test_cndeg_cn5_trajectory_matches_jax():
    # cndeg 4 under pad_deg 8: the CN sets are resampled to 4 lanes and
    # re-sorted (no row capped), in frame groups of 2, and the window
    # table's positions go off
    kw = dict(TRAJ, predictor="cn5", cndeg=4, pad_deg=8, pad_deg2=8,
              batch_size=32, linkbatchsize=8, testbs=32, window_table=True,
              frame_group=2)
    jds, tds = _ring_pair()
    jt, _, tt, _ = trajectory(kw, jds, tds, nsteps=3)
    assert not tt._window_table()


def test_increasealpha_ramp(cora_pair):
    kw = dict(TRAJ, predictor="cn2", increasealpha=True, alpha=0.3,
              batch_size=4096)  # no batch: the epochs only set the ramp
    tt = TTrainer(TConfig(**kw), cora_pair[1], device="cpu")
    state = tt.init_state(0)
    assert float(state.sched["alpha2"]) == pytest.approx(0.3)
    got = []
    with pytest.warns(RuntimeWarning, match="ZERO batches"):
        for epoch in range(1, 17):
            state, _ = tt.train_epoch(state, np.random.default_rng(epoch), epoch)
            got.append(float(state.sched["alpha2"]))
    want = [max(0.0, min((e - 5) * 0.1, 1.0)) for e in range(1, 17)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the frame-based predictors have no sched, so the flag is a no-op there
    cn5 = TTrainer(TConfig(**dict(kw, predictor="cn5")), cora_pair[1], device="cpu")
    assert cn5.init_state(0).sched == {}


def test_cn4_is_cn2():
    a = tbuild("cn4", HID, HID, **BASE)
    b = tbuild("cn2", HID, HID, **BASE)
    assert not a.higher_order and type(a) is type(b)
    assert [n for n, _ in a.named_parameters()] == [n for n, _ in b.named_parameters()]


@pytest.mark.parametrize("lane", [True, False])
def test_preedp_trains_with_the_tables_attached(cora_pair, lane, monkeypatch):
    # DropAdj in the family: lane masks on the gathered windows (the tables
    # stay attached), or with lane_dropadj off the value-mutation DropAdj of
    # the graph, which detaches them per chunk; both train finitely, as
    # tests/test_lane_drop.py checks for the JAX package
    from ocn_tpu_torch.sparse.csr import Graph

    kw = dict(TRAJ, predictor="cn2", preedp=0.4, predp=0.1, lane_dropadj=lane,
              trndeg=4, tstdeg=8, pad_deg=32, k_small=4)
    tt = TTrainer(TConfig(**kw), cora_pair[1], device="cpu")
    assert tt._use_ell
    tt._refresh_ell(np.random.default_rng(0))
    drops = []
    drop_edges = Graph.drop_edges
    monkeypatch.setattr(Graph, "drop_edges", lambda g, p, gen=None: (
        drops.append(p), drop_edges(g, p, gen))[1])
    idx = np.arange(kw["batch_size"])
    pe, ne, mp, ip, inn = tt.prepare_batch(tt.train_edges[:, idx],
                                           tt.train_edges[::-1][:, idx], idx)
    _, loss = tt.train_step(tt.init_state(0), pe, ne, mp,
                            torch.Generator().manual_seed(0), ip, inn)
    assert torch.isfinite(loss) and bool(drops) != lane

"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
same inputs through a JAX predictor or trainer and its counterpart in
ocn_tpu_torch, weights copied with weights.params_from_jax.  Not a test
file: pytest collects nothing here."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ocn_tpu.config import Config as JConfig
from ocn_tpu.nn.predictors import build_predictor as jbuild
from ocn_tpu.train.loop import Trainer as JTrainer
from ocn_tpu_torch.config import Config as TConfig
from ocn_tpu_torch.nn.predictors import build_predictor as tbuild
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.train.loop import Trainer as TTrainer
from ocn_tpu_torch.weights import load_predictor, params_from_jax

TOL = dict(rtol=1e-4, atol=1e-6)


def assert_param_grads(tp, jgrads, ema, **tol):
    """Every parameter gradient of the port's predictor ``tp`` against the
    JAX gradient tree: the tree is loaded into a copy of ``tp`` by the same
    mapping as its weights, so layouts (transposed kernels) line up."""
    ref = copy.deepcopy(tp)
    load_predictor(ref, jax.device_get(jgrads), jax.device_get(ema))
    want = dict(ref.named_parameters())
    for name, p in tp.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(),
                                   err_msg=name, **tol)


def predictor_sequence(name, kw, steps, hid=16, **tol):
    """Run the predictor ``name`` over ``steps`` on both sides, each a dict
    with the JAX and torch frames ("jframes", "tframes": the CN frames in
    the predictor's order), the targets "tar", node states "x" (NumPy), the
    graph "jg", "n", "training", and optionally "jwin"/"twin" ((y, pos) of
    the window-table path).  Forward values, the input gradient, every
    parameter gradient and the EMA state are compared at each step."""
    tol = tol or TOL
    s0 = steps[0]
    n = s0["n"]
    jp = jbuild(name, hid, n, **kw)
    variables = jp.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)},
                        jnp.asarray(s0["x"]), s0["jg"], *s0["jframes"],
                        jnp.asarray(s0["tar"]), False)
    params, ema = variables["params"], variables.get("ema", {})
    tp = tbuild(name, hid, hid, n_nodes=n, **kw)
    load_predictor(tp, jax.device_get(params), jax.device_get(ema))
    for st in steps:
        x, tar, training = st["x"], st["tar"], st["training"]
        ct = np.random.default_rng(int(tar.sum())).standard_normal(
            (tar.shape[1], 1)).astype(np.float32)
        jy, jpos = st.get("jwin", (None, None))

        def jfun(p, xx):
            out, upd = jp.apply({"params": p, "ema": ema}, xx, st["jg"],
                                *st["jframes"], jnp.asarray(tar), training,
                                mutable=["ema"], y=jy, pos=jpos)
            return jnp.sum(out * ct), (out, upd.get("ema", ema))

        (_, (jout, ema)), (jgp, jgx) = jax.value_and_grad(
            jfun, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        tp.train(training)
        tp.zero_grad()
        xt = torch.as_tensor(x).requires_grad_()
        ty, tpos = st.get("twin", (None, None))
        out = tp(xt, n, *st["tframes"], torch.as_tensor(tar), y=ty, pos=tpos)
        (out * torch.as_tensor(ct)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **tol)
        assert_param_grads(tp, jgp, ema, **tol)
        if ema:
            np.testing.assert_allclose(float(tp.innerprod),
                                       float(ema["innerprod"]), **tol)
            assert int(tp.n) == int(ema["n"])
        else:
            assert not hasattr(tp, "innerprod")
    return tp


def trainer_pair(kw, jds, tds):
    """JAX and port trainers on the same config and dataset, the port's
    modules loaded with the JAX initial state; ELL tables built from one
    NumPy seed on both sides when they are on."""
    jt = JTrainer(JConfig(**kw), jds)
    tt = TTrainer(TConfig(**kw), tds, device="cpu")
    js = jt.init_state(0)
    ts = tt.init_state(0)
    params_from_jax(*jax.device_get((js.params, js.ema)), ts.encoder, ts.predictor)
    if tt._use_ell:
        jt._refresh_ell(np.random.default_rng(7))
        tt._refresh_ell(np.random.default_rng(7))
    return jt, js, tt, ts


def trajectory(kw, jds, tds, nsteps=5, on_step=None, rtol=1e-4):
    """``nsteps`` training steps on identical batches, then one train_epoch
    from one NumPy seed, then evaluate, both packages; losses, the EMA
    state and Hits@K within ``rtol``.  ``on_step(tt)`` runs after each of the
    port's steps.  Returns the trainers and states."""
    jt, js, tt, ts = trainer_pair(kw, jds, tds)
    e = tt.train_edges.shape[1]
    rng = np.random.default_rng(5)
    perm = rng.permutation(e)
    neg = B.negative_sampling(tt.ds.edge_index, tt.ds.n_nodes, e, rng)
    bs = kw["batch_size"]
    assert e >= nsteps * bs
    gen = torch.Generator().manual_seed(0)
    jl, tl = [], []
    for i in range(nsteps):
        idx = perm[i * bs:(i + 1) * bs]
        pos_b, neg_b = tt.train_edges[:, idx], neg[:, idx]
        pe, ne, mp, ip, inn = jt.prepare_batch(pos_b, neg_b, idx)
        js, loss = jt.train_step(js, pe, ne, mp, jax.random.PRNGKey(i), ip, inn)
        jl.append(float(loss))
        pe, ne, mp, ip, inn = tt.prepare_batch(pos_b, neg_b, idx)
        ts, loss = tt.train_step(ts, pe, ne, mp, gen, ip, inn)
        tl.append(float(loss))
        if on_step is not None:
            on_step(tt)
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert len(set(jl)) == nsteps  # the loss moves: the steps really train

    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    js, jloss = jt.train_epoch(js, rj, 1)
    ts, tloss = tt.train_epoch(ts, rt, 1)
    np.testing.assert_allclose(tloss, jloss, rtol=rtol)
    ema = jax.device_get(js.ema)
    if ema:
        assert int(ts.predictor.n) == int(ema["n"])
        np.testing.assert_allclose(float(ts.predictor.innerprod),
                                   float(ema["innerprod"]), rtol=rtol)
    want = jt.evaluate(js)
    got = tt.evaluate(ts)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)
    return jt, js, tt, ts


def frame_steps(three_hop=False, k=8, k2=16, k3=8, hid=16):
    """Four link chunks of CN frames on a small graph, built by each
    package: two of train edges, two of random pairs, the first three in
    training mode.  k and k2 sit below the largest degrees, so capped rows
    take their first window (no random stream) with deg/k weights.  With
    ``three_hop`` the frames carry cn6's third frame from a capped A^3."""
    from ocn_tpu.ops import frame as jf
    from ocn_tpu.sparse import build as JB
    from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
    from ocn_tpu_torch.data.loaders import synthetic_dataset
    from ocn_tpu_torch.ops import frame as tf
    from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph

    ds = synthetic_dataset("Cora", seed=2, scale=0.1)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    assert int(np.diff(ip).max()) > k
    ip2, col2, val2 = B.adj2_csr(ip, col, n, cap=1024)
    jg, tg = jgraph(ip, col, n), tgraph(ip, col, n)
    ja2 = jgraph(ip2, col2, n, val2, gather_only=True)
    ta2 = tgraph(ip2, col2, n, val2, gather_only=True)
    if three_hop:
        n2 = int(ip2[-1])
        a3 = JB.spgemm_csr(ip2, col2[:n2], val2[:n2], ip, col, None, n, cap=256)
        ja3 = jgraph(*a3[:2], n, a3[2], gather_only=True)
        ta3 = tgraph(*a3[:2], n, a3[2], gather_only=True)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, hid)).astype(np.float32)
    win = (jnp.asarray(x)[jg.col], torch.as_tensor(x)[tg.col])
    steps = []
    for i in range(4):
        tar = (ds.split_edge["train"]["edge"][i * 24:(i + 1) * 24].T if i < 2
               else rng.integers(0, n, size=(2, 24)))
        j1, j2, jsrc = jf.cn_frames(jg, jnp.asarray(tar), k=k, k2=k2,
                                    adj2=ja2, with_src=True)
        t1, t2, tsrc = tf.cn_frames(tg, torch.as_tensor(tar), k=k, k2=k2,
                                    adj2=ta2, with_src=True)
        jframes, tframes = [j1, j2], [t1, t2]
        if three_hop:
            jframes.append(jf.cn3_frame(jg, jnp.asarray(tar), jsrc, k2=k3,
                                        k3=k3, adj3=ja3))
            tframes.append(tf.cn3_frame(tg, torch.as_tensor(tar), tsrc, k2=k3,
                                        k3=k3, adj3=ta3))
        steps.append(dict(n=n, jg=jg, x=x, tar=tar, training=i < 3,
                          jframes=jframes, tframes=tframes,
                          jwin=(win[0], jsrc.pos), twin=(win[1], tsrc.pos)))
    return steps


def without_window(steps):
    return [{k: v for k, v in s.items() if k not in ("jwin", "twin")}
            for s in steps]

"""Port parity: the cn5 (OCN) layer — ops/ortho.py and the OCNPredictor.

orthogonalize runs over a multi-step EMA sequence on frames that hold
colsum == 1 quirk columns, on both its paths (the fused sorted-domain one
with a FrameIndex and the plain one), values and gradients.  The predictor
runs several training chunks (the EMA buffers advance) and then eval, from
weights copied out of the JAX module.  Tolerance rtol=1e-5, atol=1e-6 in
float32: the two sides sum the same terms in a different order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.nn.predictors import build_predictor as jbuild
from ocn_tpu.ops import frame as jf
from ocn_tpu.ops import ortho as jo
from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.nn.predictors import build_predictor as tbuild
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.ops import ortho as to
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph
from ocn_tpu_torch.weights import load_predictor
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

TOL = dict(rtol=1e-5, atol=1e-6)


def _frames(seed, b=20, k=10, n=40):
    """Shared sorted ids with sentinel lanes and two value planes drawn from
    {0, 0.5, 1, 2}, so some columns sum to exactly 1 (the quirk rule)."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n + 1, size=(b, k)), axis=-1).astype(np.int32)
    levels = np.array([0.0, 0.0, 0.5, 1.0, 1.0, 2.0], np.float32)
    v1 = levels[rng.integers(0, len(levels), size=ids.shape)]
    v2 = levels[rng.integers(0, len(levels), size=ids.shape)]
    v1[ids == n] = 0.0
    v2[ids == n] = 0.0
    return ids, v1, v2, n


def _colsums(ids, val, n):
    return np.bincount(ids.reshape(-1), val.reshape(-1), minlength=n + 1)[:n]


def test_frames_hold_quirk_columns():
    for seed in range(4):
        ids, v1, _, n = _frames(seed)
        s = _colsums(ids, v1, n)
        assert (s == 1).any() and ((s != 0) & (s != 1)).any()


@pytest.mark.parametrize("fused", [True, False])
def test_orthogonalize_ema_sequence(fused):
    """Four training chunks thread (ema, n), then one eval chunk reads the
    stored inner product; every output and both gradients match."""
    jema, jn = jnp.zeros(()), jnp.zeros((), jnp.int32)
    tema, tn = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    for step, training in enumerate([True] * 4 + [False]):
        ids, v1, v2, n = _frames(step)
        rng = np.random.default_rng(100 + step)
        ct1 = rng.standard_normal(ids.shape).astype(np.float32)
        ct2 = rng.standard_normal(ids.shape).astype(np.float32)

        def jfun(a, b):
            c1, c2 = jf.CNFrame(jnp.asarray(ids), a, n), jf.CNFrame(jnp.asarray(ids), b, n)
            fidx = jf.frame_index(jnp.asarray(ids), n) if fused else None
            n1, o2, e, c = jo.orthogonalize(c1, c2, jema, jn, training, 0.0, fidx)
            return (n1.val, o2.val), (e, c)

        (jn1, jo2), vjp, (jema, jn) = jax.vjp(
            jfun, jnp.asarray(v1), jnp.asarray(v2), has_aux=True)
        jg1, jg2 = vjp((jnp.asarray(ct1), jnp.asarray(ct2)))

        ti = torch.as_tensor(ids)
        a = torch.as_tensor(v1).requires_grad_()
        b = torch.as_tensor(v2).requires_grad_()
        fidx = tf.frame_index(ti, n) if fused else None
        n1, o2, tema, tn = to.orthogonalize(tf.CNFrame(ti, a, n), tf.CNFrame(ti, b, n),
                                            tema, tn, training, 0.0, fidx)
        (n1.val * torch.as_tensor(ct1) + o2.val * torch.as_tensor(ct2)).sum().backward()
        tema = tema.detach()  # carried state, as the JAX side's aux output

        np.testing.assert_allclose(n1.val.detach().numpy(), np.asarray(jn1), **TOL)
        np.testing.assert_allclose(o2.val.detach().numpy(), np.asarray(jo2), **TOL)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg1), **TOL)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(jg2), **TOL)
        np.testing.assert_allclose(float(tema), float(jema), **TOL)
        assert int(tn) == int(jn) == min(step + 1, 4)
        # quirk columns (colsum exactly 1) come out of ncn1 as 0
        s = _colsums(ids, v1, n)
        quirk = np.isin(ids, np.nonzero(s == 1)[0]) & (v1 != 0)
        assert quirk.any() and (n1.val.detach().numpy()[quirk] == 0).all()


def test_ortho_pieces_match():
    ids, v1, v2, n = _frames(7)
    jc1, jc2 = jf.CNFrame(jnp.asarray(ids), jnp.asarray(v1), n), jf.CNFrame(jnp.asarray(ids), jnp.asarray(v2), n)
    ti = torch.as_tensor(ids)
    tc1, tc2 = tf.CNFrame(ti, torch.as_tensor(v1), n), tf.CNFrame(ti, torch.as_tensor(v2), n)
    for fused in (False, True):
        jx = jf.frame_index(jnp.asarray(ids), n) if fused else None
        tx = tf.frame_index(ti, n) if fused else None
        for fill in (0.0, 3.0):
            np.testing.assert_allclose(to.colnorm_quirk(tc1, fill, tx).val.numpy(),
                                       np.asarray(jo.colnorm_quirk(jc1, fill, jx).val), **TOL)
        np.testing.assert_allclose(to.colnorm_plain(tc2, tx).val.numpy(),
                                   np.asarray(jo.colnorm_plain(jc2, jx).val), **TOL)
    ip = 0.37
    np.testing.assert_allclose(
        to.gram_schmidt(tc2, tc1, torch.tensor(ip)).val.numpy(),
        np.asarray(jo.gram_schmidt(jc2, jc1, jnp.asarray(ip)).val), **TOL)
    got = to.ema_inner_product(tc2, tc1, torch.tensor(0.25), torch.tensor(3, dtype=torch.int32), True)
    want = jo.ema_inner_product(jc2, jc1, jnp.asarray(0.25), jnp.asarray(3, jnp.int32), True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


@pytest.fixture(scope="module")
def chunks():
    """cn1/cn2 frames of four link chunks on a small graph with its capped
    A^2 (frame caps above every degree), plus hidden states."""
    ds = synthetic_dataset("Cora", seed=2, scale=0.1)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    ip2, col2, val2 = B.adj2_csr(ip, col, n, cap=1024)
    k, k2 = 32, 128
    assert int(np.diff(ip).max()) <= k and int(np.diff(ip2).max()) <= k2
    jg, tg = jgraph(ip, col, n), tgraph(ip, col, n)
    ja2 = jgraph(ip2, col2, n, val2, gather_only=True)
    ta2 = tgraph(ip2, col2, n, val2, gather_only=True)
    rng = np.random.default_rng(3)
    out = []
    for i in range(4):
        tar = (ds.split_edge["train"]["edge"][i * 24:(i + 1) * 24].T if i < 2
               else rng.integers(0, n, size=(2, 24)))
        jc = jf.cn_frames(jg, jnp.asarray(tar), k=k, k2=k2, adj2=ja2)
        tc = tf.cn_frames(tg, torch.as_tensor(tar), k=k, k2=k2, adj2=ta2)
        out.append((tar, jc, tc))
    x = rng.standard_normal((n, 16)).astype(np.float32)
    return dict(n=n, jg=jg, x=x, chunks=out)


@pytest.mark.parametrize("ln,tailact,twolayerlin", [
    (True, True, False),    # the main path's predictor
    (False, False, True),
])
def test_ocn_predictor_matches(chunks, ln, tailact, twolayerlin):
    n, x, hid = chunks["n"], chunks["x"], 16
    kw = dict(dropout=0.0, ln=ln, tailact=tailact, twolayerlin=twolayerlin,
              use_xlin=True, beta=0.8)
    jp = jbuild("cn5", hid, n, **kw)
    tar0, (jc1, jc2), _ = chunks["chunks"][0]
    variables = jp.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                        jnp.asarray(x), chunks["jg"], jc1, jc2, jnp.asarray(tar0), False)
    params, ema = variables["params"], variables["ema"]
    tp = tbuild("cn5", hid, hid, **kw)
    load_predictor(tp, jax.device_get(params), jax.device_get(ema))
    tp.train()
    for i, (tar, (jc1, jc2), (tc1, tc2)) in enumerate(chunks["chunks"]):
        rng = np.random.default_rng(50 + i)
        ct = rng.standard_normal((tar.shape[1], 1)).astype(np.float32)
        training = i < 3

        def jfun(p, xx):
            out, upd = jp.apply({"params": p, "ema": ema}, xx, chunks["jg"], jc1, jc2,
                                jnp.asarray(tar), training, mutable=["ema"])
            return jnp.sum(out * ct), (out, upd["ema"])

        (_, (jout, ema)), (jgp, jgx) = jax.value_and_grad(
            jfun, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        tp.train(training)
        tp.zero_grad()
        xt = torch.as_tensor(x).requires_grad_()
        out = tp(xt, n, tc1, tc2, torch.as_tensor(tar))
        (out * torch.as_tensor(ct)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
        np.testing.assert_allclose(tp.alpha.grad.numpy(), np.asarray(jgp["alpha"]), **TOL)
        np.testing.assert_allclose(tp.beta.grad.numpy(), np.asarray(jgp["beta"]), **TOL)
        np.testing.assert_allclose(tp.xcn2lin.dense[0].weight.grad.numpy(),
                                   np.asarray(jgp["CNAggMLP_1"]["Dense_0"]["kernel"]).T, **TOL)
        np.testing.assert_allclose(float(tp.innerprod), float(ema["innerprod"]), **TOL)
        assert int(tp.n) == int(ema["n"]) == min(i + 1, 3)

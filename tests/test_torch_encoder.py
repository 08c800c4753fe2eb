"""Port parity: the encoder layer (ops/spmm.py, nn/conv.py, nn/encoder.py).

Tolerance rtol=1e-5, atol=1e-6 in float32: both sides sum the same terms in
a different order.  SpMM ``dval`` is held against the JAX one-shot path and
against sum_h x[col]*dout[row], never the JAX blocked branch (its scan
keeps the carry instead of the outputs, ROADMAP.md queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.nn.encoder import GCNEncoder as JEncoder
from ocn_tpu.ops import spmm as jspmm
from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
from ocn_tpu_torch.nn.encoder import GCNEncoder as TEncoder
from ocn_tpu_torch.ops import spmm as tspmm
from ocn_tpu_torch.sparse.build import csr_from_edge_index
from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph
from ocn_tpu_torch.weights import load_encoder
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

TOL = dict(rtol=1e-5, atol=1e-6)


def _graphs(rng, n=60, p=0.1, masked=0):
    dense = np.triu(rng.random((n, n)) < p, 1)
    dense = dense | dense.T
    ei = np.stack(np.nonzero(dense))
    ip, col = csr_from_edge_index(ei, n, symmetrize=False)
    val = None
    if masked:
        val = np.ones(col.shape[0], np.float32)
        val[rng.choice(col.shape[0], masked, replace=False)] = 0.0
    return jgraph(ip, col, n, val), tgraph(ip, col, n, val)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_spmm_forward(rng, aggr):
    jg, tg = _graphs(rng, masked=10)
    x = rng.standard_normal((jg.n_nodes, 8)).astype(np.float32)
    want = np.asarray(jspmm.spmm(jg, jnp.asarray(x), aggr))
    got = tspmm.spmm(tg, torch.as_tensor(x), aggr).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("conv", ["gcn_norm_conv", "gcn_selfloop_conv"])
def test_gcn_convs(rng, conv):
    jg, tg = _graphs(rng, masked=6)
    x = rng.standard_normal((jg.n_nodes, 8)).astype(np.float32)
    want = np.asarray(getattr(jspmm, conv)(jg, jnp.asarray(x)))
    got = getattr(tspmm, conv)(tg, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("blocked", [False, True])
def test_spmm_sum_gradients(rng, monkeypatch, blocked):
    jg, tg = _graphs(rng)
    n, h = jg.n_nodes, 8
    x = rng.standard_normal((n, h)).astype(np.float32)
    ct = rng.standard_normal((n, h)).astype(np.float32)
    vals = np.array(jg.val)

    def jfun(xx, vv):
        return jnp.sum(jspmm.spmm(jg.with_values(vv), xx, "sum") * ct)

    # with_values drops packed but keeps tpos: the custom-VJP path
    jdx, jdv = jax.grad(jfun, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(vals))
    if blocked:  # force several edge blocks on the port side only
        monkeypatch.setattr(tspmm, "_SPMM_BLOCK_BYTES", 1024)
    xt = torch.as_tensor(x).requires_grad_()
    vt = torch.as_tensor(vals).requires_grad_()
    out = tspmm.spmm(tg.with_values(vt), xt, "sum")
    (out * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jdv), **TOL)
    # dval against its definition: <x[col[p]], dout[row[p]]>
    row, col = tg.row.numpy(), tg.col.numpy()
    np.testing.assert_allclose(vt.grad.numpy(), (x[col] * ct[row]).sum(-1), **TOL)


@pytest.mark.parametrize("conv_fn,layers,ln,res,jk", [
    ("gcn", 3, True, True, True),       # the main path's encoder
    ("gcn", 1, True, False, True),
    ("sage", 2, False, True, False),
    ("gin", 2, True, False, False),
    ("puregcn", 1, False, False, True),
    ("puremean", 2, False, True, False),
])
def test_encoder_eval_matches(rng, conv_fn, layers, ln, res, jk):
    jg, tg = _graphs(rng, masked=8)
    f, hid = 12, 16
    x = rng.standard_normal((jg.n_nodes, f)).astype(np.float32)
    kw = dict(num_layers=layers, dropout=0.3, ln=ln, res=res, conv_fn=conv_fn,
              jk=jk, edrop=0.2, xdropout=0.3, taildropout=0.1)
    jenc = JEncoder(hidden=hid, **kw)
    params = jenc.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                       jnp.asarray(x), jg, False)["params"]
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x), jg, False))
    tenc = TEncoder(in_features=f, hidden=hid, **kw)
    load_encoder(tenc, jax.device_get(params))
    tenc.eval()
    with torch.no_grad():
        got = tenc(torch.as_tensor(x), tg).numpy()
    # atol scaled to the output's magnitude (raw JK weights and residuals
    # grow it past 1; entries near zero come out of cancellation)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_encoder_training_mode_draws_dropout():
    g = _graphs(np.random.default_rng(0))[1]
    enc = TEncoder(in_features=4, hidden=8, num_layers=2, dropout=0.5, ln=True,
                   jk=True, edrop=0.5, xdropout=0.5)
    x = torch.randn(g.n_nodes, 4)
    enc.eval()
    a, b = enc(x, g), enc(x, g)
    assert torch.equal(a, b)
    enc.train()
    c = enc(x, g, torch.Generator().manual_seed(0))
    d = enc(x, g, torch.Generator().manual_seed(0))
    e = enc(x, g, torch.Generator().manual_seed(1))
    assert torch.equal(c, d) and not torch.equal(c, e)

"""Port parity: the pygho ("ho") encoder stack (nn/conv.py PureConvV2 and
LinConv, nn/encoder.py with stack="ho"), and the Trainer on the two README
datasets that use it: ppa (integer features through an Embedding,
path-count cn2, maskinput, ELL tables and the dual-K split) and citation2
(randint-target negatives, MRR eval).

Convs and encoders hold forward values and input gradients at rtol 1e-5
(float32 sums in another order); trajectories hold losses, the EMA state,
Hits@K and MRR at rtol 1e-4, at learning rates 1e-3 as in
tests/test_torch_cn6.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import cut_splits
from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.nn.conv import LinConv as JLinConv
from ocn_tpu.nn.conv import PureConvV2 as JPureConvV2
from ocn_tpu.nn.encoder import GCNEncoder as JEncoder
from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
from ocn_tpu_torch import cli as tcli
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.nn import conv as tconv
from ocn_tpu_torch.nn.encoder import GCNEncoder as TEncoder
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph
from ocn_tpu_torch.weights import load_encoder
from torch_parity import trajectory
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def masked():
    """A skewed graph with one batch of target edges masked out in both
    directions (maskinput), as both packages build it."""
    ds = tsynthetic("Cora", seed=5, scale=0.05)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    pos = np.maximum(B.edge_to_nnz_positions(
        ip, col, ds.split_edge["train"]["edge"][:12].T).reshape(-1), 0)
    jg = jgraph(ip, col, n).mask_edges(jnp.asarray(pos))
    tg = tgraph(ip, col, n).mask_edges(torch.as_tensor(pos))
    assert int((tg.val == 0).sum()) > 4096  # the pad, and the masked entries
    return jg, tg


def _grad_pair(jfun, tmod, tg, x, ct):
    """Forward values and dx of a JAX function and a port module."""
    want, vjp = jax.vjp(jfun, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    xt = torch.as_tensor(x).requires_grad_()
    got = tmod(xt, tg)
    (got * torch.as_tensor(ct)).sum().backward()
    return got.detach().numpy(), np.asarray(want), xt.grad.numpy(), np.asarray(jdx)


@pytest.mark.parametrize("aggr", ["gcn", "mean", "sum", "max"])
def test_pure_conv_v2_matches(masked, rng, aggr):
    jg, tg = masked
    x = rng.standard_normal((tg.n_nodes, 8)).astype(np.float32)
    ct = rng.standard_normal((tg.n_nodes, 8)).astype(np.float32)
    jmod = JPureConvV2(aggr)
    got, want, dx, jdx = _grad_pair(lambda xx: jmod.apply({}, xx, jg),
                                    tconv.PureConvV2(aggr), tg, x, ct)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(dx, jdx, **TOL)


def test_enorm_values_stay_symmetric_under_maskinput(masked):
    """The enorm SpMM keeps the transpose-permutation backward, which reads
    val[tpos]: the masked graph's values and their enorm weights must be
    symmetric (up to the rounding of a product in another order)."""
    _, tg = masked
    assert tg.tpos is not None
    assert torch.equal(tg.val[tg.tpos.long()], tg.val)
    norm = torch.rsqrt(1.0 + tg.value_rowsum())
    w = tg.val * norm[tg.row] * norm[tg.col]
    torch.testing.assert_close(w[tg.tpos.long()], w, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("aggr", ["gcn", "max"])
def test_linconv_matches(masked, rng, aggr):
    jg, tg = masked
    x = rng.standard_normal((tg.n_nodes, 6)).astype(np.float32)
    ct = rng.standard_normal((tg.n_nodes, 10)).astype(np.float32)
    jmod = JLinConv(10, aggr)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)["params"]
    tmod = tconv.make_conv("gcn" if aggr == "gcn" else "max", 6, 10, stack="ho")
    assert isinstance(tmod, tconv.LinConv) and tmod.conv.aggr == aggr
    with torch.no_grad():
        tmod.lin.weight.copy_(torch.as_tensor(np.asarray(params["Dense_0"]["kernel"]).T))
    got, want, dx, jdx = _grad_pair(
        lambda xx: jmod.apply({"params": params}, xx, jg), tmod, tg, x, ct)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(dx, jdx, **TOL)
    assert (got == 0).any() and (got > 0).any()  # the ReLU is there


@pytest.mark.parametrize("conv_fn,layers,ln,res,jk,max_x", [
    ("gcn", 2, True, True, True, -1),
    ("puregcn", 3, False, False, True, -1),
    ("gcn", 1, True, False, True, 9),      # ppa: integer features, Embedding
])
def test_ho_encoder_matches(masked, rng, conv_fn, layers, ln, res, jk, max_x):
    """The encoder under stack="ho", eval mode: forward and dx (the Embedding
    input has no dx; its output and the weight gradient are compared)."""
    jg, tg = masked
    n, f, hid = tg.n_nodes, 12, 16
    if max_x >= 0:
        x = rng.integers(0, max_x + 1, size=n).astype(np.int32)
    else:
        x = rng.standard_normal((n, f)).astype(np.float32)
    ct = rng.standard_normal((n, hid)).astype(np.float32)
    kw = dict(num_layers=layers, dropout=0.3, ln=ln, res=res, conv_fn=conv_fn,
              jk=jk, edrop=0.2, xdropout=0.3, taildropout=0.1, max_x=max_x)
    jenc = JEncoder(hidden=hid, stack="ho", apply_adjdrop=False, **kw)
    params = jenc.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x), jg,
                       False)["params"]
    tenc = TEncoder(in_features=f, hidden=hid, stack="ho", **kw)
    load_encoder(tenc, jax.device_get(params))
    tenc.eval()
    kinds = {type(c).__name__ for c in tenc.convs}
    assert kinds == ({"PureConvV2"} if conv_fn.startswith("pure") else {"LinConv"})
    if max_x >= 0:
        def jfun(p):
            return jenc.apply({"params": p}, jnp.asarray(x), jg, False)

        want, vjp = jax.vjp(jfun, params)
        (jgp,) = vjp(jnp.asarray(ct))
        got = tenc(torch.as_tensor(x), tg)
        (got * torch.as_tensor(ct)).sum().backward()
        jge = np.asarray(jgp["Embed_0"]["embedding"])
        # sums over every node of a row id: atol scaled to their magnitude
        np.testing.assert_allclose(tenc.emb.weight.grad.numpy(), jge,
                                   rtol=1e-5, atol=1e-6 * np.abs(jge).max())
        got, want = got.detach().numpy(), np.asarray(want)
    else:
        got, want, dx, jdx = _grad_pair(
            lambda xx: jenc.apply({"params": params}, xx, jg, False), tenc, tg, x, ct)
        np.testing.assert_allclose(dx, jdx, rtol=1e-5, atol=1e-6 * np.abs(jdx).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("conv_fn", ["gcn", "puregcn"])
def test_ho_encoder_never_drops_edges(masked, rng, conv_fn):
    """GCN2/GCN3 build DropAdj but never apply it: with every dropout at 0,
    a training-mode forward at gnnedp 0.5 equals the eval-mode one, and
    draws nothing from the generator; under "ts" it does drop edges."""
    _, tg = masked
    x = torch.as_tensor(rng.standard_normal((tg.n_nodes, 12)).astype(np.float32))
    kw = dict(in_features=12, hidden=16, num_layers=2, dropout=0.0, ln=True,
              conv_fn=conv_fn, edrop=0.5)
    for stack in ("ho", "ts"):
        enc = TEncoder(stack=stack, **kw)
        enc.eval()
        want = enc(x, tg)
        enc.train()
        gen = torch.Generator().manual_seed(0)
        got = enc(x, tg, gen)
        if stack == "ho":
            assert torch.equal(got, want)
            assert torch.equal(gen.get_state(), torch.Generator().manual_seed(0).get_state())
        else:
            assert not torch.allclose(got, want)


# the trainers: ppa and citation2 at a tiny scale through their README
# presets' shape (the "ho" stack, cn2 path counts; gnnedp > 0, which the
# stack ignores), every other dropout 0, learning rates 1e-3, on ELL tables
# with the dual-K split: capped rows ride the tables, whose offsets NumPy
# draws on both sides, so no random stream is read
HO = dict(encoder_stack="ho", cn2_counts=True, hiddim=16, gnndp=0.0, xdp=0.0,
          tdp=0.0, gnnedp=0.3, predp=0.0, preedp=0.0, gnnlr=0.001,
          prelr=0.001, use_xlin=True, tailact=True, lnnn=True, batch_size=64,
          linkbatchsize=16, testbs=256, ell_tables=True, k_small=8,
          pad_deg=16, pad_deg2=16)
# ppa's degrees sit above k_small, so the split's shares are set
PPA = dict(HO, model="gcn", mplayers=1, ln=True, jk=True, maskinput=True,
           adj2_cap=64, small_frac=0.25, small_frac_neg=0.25)
CITATION2 = dict(HO, model="puregcn", mplayers=3, ln=True, res=True, jk=True,
                 neg_mode="randint_target")


@pytest.fixture(scope="module")
def ppa():
    return tuple(cut_splits(f("ppa", seed=0, scale=0.0005).reorder_bfs(), 640, 300)
                 for f in (jsynthetic, tsynthetic))


@pytest.fixture(scope="module")
def citation2():
    return tuple(cut_splits(f("citation2", seed=0, scale=0.0003).reorder_bfs(),
                            640, 48)
                 for f in (jsynthetic, tsynthetic))


def test_ppa_trajectory_matches_jax(ppa):
    jt, _, tt, _ = trajectory(PPA, *ppa)
    assert tt.x.dtype == torch.int64 and tt.ds.max_x == 57
    assert tt._use_ell and tt._split == jt._split and tt._split is not None
    assert int(tt.g.deg.max()) > PPA["pad_deg"]  # capped rows ride the tables


def test_citation2_trajectory_and_mrr_match_jax(citation2):
    """Five steps, an epoch whose negatives keep the positive sources, Hits
    and MRR."""
    jt, js, tt, ts = trajectory(CITATION2, *citation2)
    assert tt._use_ell and tt._split == jt._split and tt._split is not None
    want = jt.evaluate_mrr(js)
    got = tt.evaluate_mrr(ts)
    assert got.keys() == want.keys() == {"valid", "test"}
    for part in want:
        np.testing.assert_allclose(got[part], want[part], rtol=1e-4, err_msg=part)
        assert 0.0 < got[part] <= 1.0


@pytest.mark.filterwarnings("ignore:dataset 'citation2' unavailable offline")
def test_cli_citation2_preset_reports_mrr(capsys):
    """The citation2 README preset through the CLI, cut to a small graph:
    the "ho" stack, randint-target negatives, and MRR as the headline."""
    cfg = tcli.parseargs([
        "--dataset", "citation2", "--predictor", "cn5", "--preset",
        "--epochs", "1", "--runs", "1", "--synthetic_scale", "0.0002",
        "--batch_size", "256", "--linkbatchsize", "64", "--testbs", "2048",
        "--hiddim", "16", "--platform", "cpu"])
    assert (cfg.encoder_stack, cfg.neg_mode) == ("ho", "randint_target")
    summary = tcli.run(cfg)
    out = capsys.readouterr().out
    assert summary["headline"] == "MRR" and out.count("MRR  Run: 01") == 1
    assert 0.0 < summary["val_mean"] <= 1.0 and 0.0 < summary["tst_mean"] <= 1.0

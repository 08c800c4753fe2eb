"""Port parity: ELL window tables (sparse/ell.py), the ELL branch of
gather_neighbors, and the trainer's table refresh and masking.  Tables,
offsets, mask positions and gathered frames are array-equal to the JAX
package's; with the tables on, an uncapped graph gives exactly the loss of
the plain path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.config import Config as JConfig
from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.ops import frame as jf
from ocn_tpu.sparse import ell as JELL
from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
from ocn_tpu.train.loop import Trainer as JTrainer
from ocn_tpu_torch.config import Config
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse import ell as ELL
from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph
from ocn_tpu_torch.train.loop import Trainer
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)


@pytest.fixture(scope="module")
def graph():
    """A Zipf-skewed graph (hubs exceed the table widths) with one batch of
    target edges masked out."""
    ds = synthetic_dataset("Cora", seed=4, scale=0.15)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    edges = ds.split_edge["train"]["edge"][:60].T
    mp = np.maximum(B.edge_to_nnz_positions(ip, col, edges).reshape(-1), 0)
    deg = ip[1:] - ip[:-1]
    assert deg.max() > 16  # capping binds at the widths below
    return dict(ds=ds, n=n, ip=ip, col=col, edges=edges, mp=mp, deg=deg)


def test_draw_offsets_match(graph):
    for k in (4, 16, 64):
        want = JELL.draw_offsets(graph["deg"], k, np.random.default_rng(k))
        got = ELL.draw_offsets(graph["deg"], k, np.random.default_rng(k))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and (got <= np.maximum(graph["deg"] - k, 0)).all()


@pytest.mark.parametrize("k", [8, 32])
def test_build_ell_matches(graph, k):
    n = graph["n"]
    jg = jgraph(graph["ip"], graph["col"], n)
    tg = tgraph(graph["ip"], graph["col"], n)
    off = ELL.draw_offsets(graph["deg"], k, np.random.default_rng(1))
    want = np.asarray(JELL.build_ell(jg.packed, jg.indptr, jnp.asarray(off), k))
    got = ELL.build_ell(tg.packed, tg.indptr, torch.as_tensor(off), k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ELL.build_ell_np(tg.packed.numpy(), graph["ip"], off, k), want)


def test_mask_ell_flat_positions_match(graph):
    k = 8
    off = ELL.draw_offsets(graph["deg"], k, np.random.default_rng(2))
    args = (graph["edges"], graph["mp"], graph["ip"], off, k)
    want = JELL.mask_ell_flat_positions(*args)
    got = ELL.mask_ell_flat_positions(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[0] == -1).any() and (got[0] >= 0).any()


def test_apply_ell_mask_sentinel_next_to_full_last_row():
    """-1 positions must not wrap onto the last entry: every entry of the
    table, the last row's included, is a real neighbor here."""
    rng = np.random.default_rng(0)
    tbl = rng.integers(1, 2**30, size=(7, 5), dtype=np.int64).astype(np.int32)
    cases = [np.full(11, -1), np.array([-1, 12, -1, 33, -1])]
    for flat in cases:
        flat = flat.astype(np.int32)
        cleared = rng.integers(0, 100, size=flat.shape).astype(np.int32)
        want = np.asarray(JELL.apply_ell_mask(
            jnp.asarray(tbl), jnp.asarray(flat), jnp.asarray(cleared)))
        got = ELL.apply_ell_mask(torch.as_tensor(tbl), torch.as_tensor(flat),
                                 torch.as_tensor(cleared)).numpy()
        np.testing.assert_array_equal(got, want)
    assert got.reshape(-1)[33] == cleared[3] and got[-1, -1] == tbl[-1, -1]


@pytest.mark.parametrize("k,ell_k", [(16, 16), (4, 16), (64, 64)])
def test_gather_neighbors_ell_branch_matches(graph, k, ell_k):
    """ids, weights and CSR window positions of the ELL row gather, on the
    masked graph with its masked table; k < ell_k takes the leading lanes."""
    n, ip, col, mp = graph["n"], graph["ip"], graph["col"], graph["mp"]
    off = ELL.draw_offsets(graph["deg"], ell_k, np.random.default_rng(3))
    flat, cleared = ELL.mask_ell_flat_positions(graph["edges"], mp, ip, off, ell_k)
    jg = jgraph(ip, col, n)
    tg = tgraph(ip, col, n)
    jt = JELL.apply_ell_mask(
        JELL.build_ell(jg.packed, jg.indptr, jnp.asarray(off), ell_k),
        jnp.asarray(flat), jnp.asarray(cleared))
    tt = ELL.apply_ell_mask(
        ELL.build_ell(tg.packed, tg.indptr, torch.as_tensor(off), ell_k),
        torch.as_tensor(flat), torch.as_tensor(cleared))
    jg = jg.mask_edges(jnp.asarray(mp)).with_ell(jt, jnp.asarray(off))
    tg = tg.mask_edges(torch.as_tensor(mp)).with_ell(tt, torch.as_tensor(off))
    nodes = np.concatenate([graph["edges"].reshape(-1),
                            np.random.default_rng(4).integers(0, n, 64)])
    a = jf.gather_neighbors(jg, jnp.asarray(nodes), k)
    # the generator is ignored on the table path
    b = tf.gather_neighbors(tg, torch.as_tensor(nodes), k,
                            torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_array_equal(b.w.numpy(), np.asarray(a.w))
    np.testing.assert_array_equal(b.pos.numpy(), np.asarray(a.pos))
    assert (b.w.numpy() == 0).any()  # masked lanes
    assert (b.w.numpy() > 1).any() == (k < graph["deg"].max())  # capped rows


def test_value_edits_drop_the_table(graph):
    tg = tgraph(graph["ip"], graph["col"], graph["n"])
    off = torch.zeros(graph["n"], dtype=torch.int32)
    ge = tg.with_ell(ELL.build_ell(tg.packed, tg.indptr, off, 8), off)
    assert ge.ell_k == 8
    for edited in (ge.mask_edges(torch.as_tensor(graph["mp"])),
                   ge.with_values(ge.val * 2), ge.drop_edges(0.5)):
        assert edited.ell is None and edited.ell_off is None and edited.ell_k == 0


def _cfg(ell, **kw):
    base = dict(dataset="Cora", predictor="cn5", model="puregcn", mplayers=1,
                hiddim=16, batch_size=256, testbs=256, maskinput=True,
                pad_deg=64, pad_deg2=192, linkbatchsize=64, adj2_cap=1024,
                gnndp=0.0, xdp=0.0, tdp=0.0, gnnedp=0.0, predp=0.0, preedp=0.0,
                ell_tables=ell, k_small=0)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def cora():
    return synthetic_dataset("Cora", seed=0, scale=0.2)


def _batch(tr, ds, seed=0):
    rng = np.random.default_rng(seed)
    e = ds.split_edge["train"]["edge"].shape[0]
    pos = np.asarray(ds.split_edge["train"]["edge"]).T
    neg = B.negative_sampling(ds.edge_index, ds.n_nodes, e, rng)
    idx = rng.permutation(e)[: tr.cfg.batch_size]
    return tr.prepare_batch(pos[:, idx], neg[:, idx], idx)


@pytest.mark.parametrize("mask", [False, True])
def test_step_exactness_uncapped(cora, mask):
    """No cap binds (pad_deg > max degree, pad_deg2 > max A^2 degree): the
    tables hold whole rows, so the loss equals the plain path's exactly,
    maskinput included (tests/test_ell.py:82-97 on the JAX side)."""
    tr_e = Trainer(Config(**_cfg(True, maskinput=mask)), cora, device="cpu")
    tr_p = Trainer(Config(**_cfg(False, maskinput=mask)), cora, device="cpu")
    assert tr_e._use_ell and not tr_p._use_ell
    assert int(tr_e.g.deg.max()) <= 64 and int(tr_e.adj2.deg.max()) <= 192
    tr_e._refresh_ell(np.random.default_rng(7))
    pe, ne, mpe, _, _ = _batch(tr_e, cora)
    pp, nn, mpp, _, _ = _batch(tr_p, cora)
    assert isinstance(mpe, dict) and not isinstance(mpp, dict)
    assert ("ell_flat" in mpe) == mask
    _, le = tr_e.train_step(tr_e.init_state(0), pe, ne, mpe,
                            torch.Generator().manual_seed(3))
    _, lp = tr_p.train_step(tr_p.init_state(0), pp, nn, mpp,
                            torch.Generator().manual_seed(3))
    assert float(le) == float(lp)


def test_refresh_and_batch_aux_match_jax():
    """The trainer's tables, offsets and the prepare_batch aux dict equal
    the JAX Trainer's for the same generator (capped rows included)."""
    kw = _cfg(True, pad_deg=16, pad_deg2=16, batch_size=128)
    jds = jsynthetic("Cora", seed=0, scale=0.2)
    tds = synthetic_dataset("Cora", seed=0, scale=0.2)
    jt = JTrainer(JConfig(**kw), jds)
    tt = Trainer(Config(**kw), tds, device="cpu")
    assert int(tt.g.deg.max()) > 16 and int(tt.adj2.deg.max()) > 16
    jt._refresh_ell(np.random.default_rng(11))
    tt._refresh_ell(np.random.default_rng(11))
    for key in ("tbl1", "off1", "off1_np", "tbl2", "off2"):
        np.testing.assert_array_equal(np.asarray(tt._ell[key]),
                                      np.asarray(jt._ell[key]), err_msg=key)
    ja, ta = _batch(jt, jds, 1)[2], _batch(tt, tds, 1)[2]
    assert set(ja) == set(ta)
    for key in ja:
        np.testing.assert_array_equal(np.asarray(ta[key]), np.asarray(ja[key]),
                                      err_msg=key)

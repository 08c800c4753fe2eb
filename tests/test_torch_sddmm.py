"""Port parity: the SDDMM two-hop mode (``two_hop_mode="sddmm"``): cn2
counted on the fly as |N(k) & N(j)| by ops/frame.py cn_frames, and the
Trainer without A^2 on the ('citation2', 'spd') preset's shape.

Frames are held to the JAX function on a masked graph whose hubs exceed the
caps (capped rows take their first window on both sides): ids exactly,
values exactly where every weight is 1, else at rtol 1e-6 (the capped rows'
deg/k weights summed in another order).  The trajectory holds losses, Hits
and MRR at rtol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import cut_splits
from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.ops import frame as jf
from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph
from torch_parity import trajectory


@pytest.fixture(scope="module")
def graphs():
    """A Zipf-skewed graph with 40 target edges masked out, the 40 and 22
    random pairs as targets (a batch that no chunk of 4 divides)."""
    ds = tsynthetic("Cora", seed=4, scale=0.15)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    edges = ds.split_edge["train"]["edge"][:40].T
    pos = np.maximum(B.edge_to_nnz_positions(ip, col, edges).reshape(-1), 0)
    tar = np.concatenate(
        [edges, np.random.default_rng(7).integers(0, n, size=(2, 22))], axis=1)
    return dict(jg=jgraph(ip, col, n).mask_edges(jnp.asarray(pos)),
                tg=tgraph(ip, col, n).mask_edges(torch.as_tensor(pos)),
                tar=tar, n=n, maxdeg=int(np.diff(ip).max()))


@pytest.mark.parametrize("k,k2,counts,exact2,chunk", [
    (8, 8, False, False, 0),
    (8, 8, True, False, 0),
    (8, 16, True, True, 4),      # ragged: 62 edges in chunks of 4
    (16, 8, False, True, 4),
    (None, None, True, False, 0),  # no cap binds: every weight is 1
    (None, None, True, True, 16),
])
def test_sddmm_cn_frames_match(graphs, k, k2, counts, exact2, chunk):
    k = k or graphs["maxdeg"]
    k2 = k2 or graphs["maxdeg"]
    tar = graphs["tar"]
    # k2_dst caps N(j) in gather mode only: here it must change nothing
    kw = dict(k=k, k2=k2, cn2_counts=counts, exact_two_hop=exact2,
              count2_chunk=chunk, k2_dst=4)
    a1, a2 = jf.cn_frames(graphs["jg"], jnp.asarray(tar), **kw)
    b1, b2 = tf.cn_frames(graphs["tg"], torch.as_tensor(tar), **kw)
    for a, b in ((a1, b1), (a2, b2)):
        np.testing.assert_array_equal(np.asarray(a.ids), b.ids.numpy())
        if k == k2 == graphs["maxdeg"]:
            np.testing.assert_array_equal(np.asarray(a.val), b.val.numpy())
        else:
            np.testing.assert_allclose(np.asarray(a.val), b.val.numpy(),
                                       rtol=1e-6, atol=0.0)
    assert (b1.val != 0).any() and (b2.val != 0).any()
    # sentinel candidates (lanes past a short row) are in the batch and
    # carry nothing, though the port gathers the last row for them
    sentinel = b2.ids == graphs["n"]
    assert sentinel.any() and not b2.val[sentinel].any()
    if counts and k == graphs["maxdeg"]:  # path counts: integers, no cap binds
        assert torch.equal(b2.val, b2.val.round())


def test_count2_chunks_change_nothing(graphs):
    tar = torch.as_tensor(graphs["tar"])
    whole = tf.cn_frames(graphs["tg"], tar, k=8, k2=16, cn2_counts=True)[1]
    for chunk in (1, 4, 61, 62, 100):
        part = tf.cn_frames(graphs["tg"], tar, k=8, k2=16, cn2_counts=True,
                            count2_chunk=chunk)[1]
        assert torch.equal(part.val, whole.val), chunk


@pytest.mark.parametrize("k,launches", [(8, 2), (64, 1)])
def test_sddmm_membership_routing(graphs, monkeypatch, k, launches):
    """cn1's lookup (B, K) against (B, K2) stays on the membership kernel;
    the counts' lookup (B, K*K2) against (B, K2) takes it only while
    K*K2*K2 <= _COMPARE_LIMIT, and the binary search past it."""
    calls = []
    real = tf.membership_counts

    def counting(q, ids, w):
        calls.append((q.shape[1], ids.shape[1]))
        return real(q, ids, w)

    monkeypatch.setattr(tf, "membership_counts", counting)
    tf.cn_frames(graphs["tg"], torch.as_tensor(graphs["tar"]), k=k, k2=k)
    assert (k * k * k <= tf._COMPARE_LIMIT) == (launches == 2)
    assert calls[0] == (k, k) and len(calls) == launches


def test_sddmm_matches_gather_mode_on_uncapped_a2(rng):
    """With nothing capped, the counts read from the precomputed A^2 equal
    the ones counted on the fly (tests/test_adj2.py for the port)."""
    n = 40
    dense = np.triu(rng.random((n, n)) < 0.15, 1)
    dense = dense | dense.T
    ip, col = B.csr_from_edge_index(np.stack(np.nonzero(dense)), n, symmetrize=False)
    g = tgraph(ip, col, n)
    ip2, col2, val2 = B.adj2_csr(ip, col, n, 0)
    adj2 = tgraph(ip2, col2, n, val2, gather_only=True)
    edges = torch.as_tensor(rng.integers(0, n, size=(2, 15)))
    a2 = dense.astype(np.int64) @ dense.astype(np.int64)
    for counts in (False, True):
        for exact2 in (False, True):
            kw = dict(k=n, cn2_counts=counts, exact_two_hop=exact2)
            s1, s2 = tf.cn_frames(g, edges, **kw)
            g1, g2 = tf.cn_frames(g, edges, adj2=adj2, **kw)
            assert torch.equal(s1.val, g1.val) and torch.equal(s2.val, g2.val)
            # against the dense A^2 at each candidate
            ids = s2.ids.numpy()
            for b in range(edges.shape[1]):
                j = int(edges[1, b])
                for lane in np.nonzero(ids[b] < n)[0]:
                    c = int(a2[j, ids[b, lane]])
                    if exact2 and dense[j, ids[b, lane]]:
                        c = 0
                    want = c if counts else float(c > 0)
                    assert float(s2.val[b, lane]) == want


# the ('citation2', 'spd') preset's shape at a tiny scale: the "ho" stack,
# path counts on the fly, exactly-distance-2, randint-target negatives.
# There are no ELL tables without A^2, so the caps sit above every degree:
# windows are exact and no random stream is read
SPD = dict(encoder_stack="ho", cn2_counts=True, exact_two_hop=True,
           two_hop_mode="sddmm", neg_mode="randint_target", model="gcn",
           mplayers=2, hiddim=16, ln=True, res=True, jk=True, use_xlin=True,
           tailact=True, lnnn=True, gnndp=0.0, xdp=0.0, tdp=0.0, gnnedp=0.3,
           predp=0.0, preedp=0.0, gnnlr=0.001, prelr=0.001, batch_size=64,
           linkbatchsize=16, testbs=128, pad_deg=64, pad_deg2=64)


def test_spd_trajectory_and_mrr_match_jax():
    jds, tds = (cut_splits(f("citation2", seed=0, scale=0.00015).reorder_bfs(),
                           384, 16) for f in (jsynthetic, tsynthetic))
    jt, js, tt, ts = trajectory(SPD, jds, tds)
    assert tt.adj2 is None and jt.adj2 is None and not tt._use_ell
    assert int(tt.g.deg.max()) <= SPD["pad_deg"] == SPD["pad_deg2"]
    want, got = jt.evaluate_mrr(js), tt.evaluate_mrr(ts)
    for part in ("valid", "test"):
        np.testing.assert_allclose(got[part], want[part], rtol=1e-4, err_msg=part)

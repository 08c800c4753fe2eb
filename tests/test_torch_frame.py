"""Port parity: candidate frames (ops/frame.py) — neighbor windows, cn1/cn2
in A^2 "gather" mode, the sorted-domain index, per-entry column sums and
the shared frame matmul, values and gradients (rtol=1e-5, atol=1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.ops import frame as jf
from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def graphs():
    """A Zipf-skewed graph whose hubs exceed the frame caps, with one batch
    of target edges masked out (maskinput), and its capped A^2."""
    ds = synthetic_dataset("Cora", seed=4, scale=0.15)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    ip2, col2, val2 = B.adj2_csr(ip, col, n, cap=48)
    edges = ds.split_edge["train"]["edge"][:40].T
    pos = np.maximum(B.edge_to_nnz_positions(ip, col, edges).reshape(-1), 0)
    jg = jgraph(ip, col, n).mask_edges(jnp.asarray(pos))
    tg = tgraph(ip, col, n).mask_edges(torch.as_tensor(pos))
    ja2 = jgraph(ip2, col2, n, val2, gather_only=True)
    ta2 = tgraph(ip2, col2, n, val2, gather_only=True)
    rng = np.random.default_rng(7)
    tar = np.concatenate([edges, rng.integers(0, n, size=(2, 24))], axis=1)
    assert int(ip[1:].__sub__(ip[:-1]).max()) > 16  # some rows get capped
    return dict(jg=jg, tg=tg, ja2=ja2, ta2=ta2, tar=tar, n=n, ip=ip, col=col)


@pytest.mark.parametrize("which,k", [("g", 8), ("g", 64), ("a2", 16)])
def test_gather_neighbors_first_window(graphs, which, k):
    jg = graphs["jg"] if which == "g" else graphs["ja2"]
    tg = graphs["tg"] if which == "g" else graphs["ta2"]
    nodes = graphs["tar"][0]
    a = jf.gather_neighbors(jg, jnp.asarray(nodes), k)
    b = tf.gather_neighbors(tg, torch.as_tensor(nodes), k)
    np.testing.assert_array_equal(np.asarray(a.ids), b.ids.numpy())
    np.testing.assert_array_equal(np.asarray(a.w), b.w.numpy())
    np.testing.assert_array_equal(np.asarray(a.pos), b.pos.numpy())


def test_gather_neighbors_sampled_windows(graphs):
    """With a generator, capped rows take a contiguous in-row window with
    weight deg/k; uncapped rows are exact (random streams differ from
    JAX's by design, so the structure is what is compared)."""
    tg, k = graphs["tg"], 8
    nodes = torch.as_tensor(graphs["tar"][0])
    fr = tf.gather_neighbors(tg, nodes, k, torch.Generator().manual_seed(0))
    exact = tf.gather_neighbors(tg, nodes, k)
    deg = tg.deg[nodes.long()]
    start = tg.indptr[nodes.long()]
    for r in range(nodes.shape[0]):
        d = int(deg[r])
        if d <= k:
            assert torch.equal(fr.ids[r], exact.ids[r]) and torch.equal(fr.w[r], exact.w[r])
            continue
        p0 = int(fr.pos[r, 0])
        assert int(start[r]) <= p0 <= int(start[r]) + d - k
        assert torch.equal(fr.pos[r], p0 + torch.arange(k))
        vals = (tg.packed[p0:p0 + k] >> tg.col_bits).float()
        torch.testing.assert_close(fr.w[r], vals * d / k)


@pytest.mark.parametrize("k,k2,k2_dst,counts,exact2", [
    (16, 16, None, False, False),
    (64, 64, None, False, False),    # every row exact
    (16, 32, 8, False, False),       # narrower dst cap (pad_deg2_dst)
    (16, 16, None, True, True),      # path counts, exactly-distance-2
    (16, 16, None, True, False),     # path counts alone (the pygho stack)
    (16, 16, None, False, True),     # exactly-distance-2 alone
])
def test_cn_frames_match(graphs, k, k2, k2_dst, counts, exact2):
    tar = graphs["tar"]
    corr = np.zeros(tar.shape[1], np.float32)
    corr[:40] = 1.0  # the masked (positive) edges
    a1, a2 = jf.cn_frames(graphs["jg"], jnp.asarray(tar), k=k, k2=k2,
                          adj2=graphs["ja2"], self_corr=jnp.asarray(corr),
                          k2_dst=k2_dst, cn2_counts=counts, exact_two_hop=exact2)
    b1, b2 = tf.cn_frames(graphs["tg"], torch.as_tensor(tar), k=k, k2=k2,
                          adj2=graphs["ta2"], self_corr=torch.as_tensor(corr),
                          k2_dst=k2_dst, cn2_counts=counts, exact_two_hop=exact2)
    for a, b in ((a1, b1), (a2, b2)):
        np.testing.assert_array_equal(np.asarray(a.ids), b.ids.numpy())
        np.testing.assert_allclose(np.asarray(a.val), b.val.numpy(), **TOL)
    assert (b1.val != 0).any() and (b2.val != 0).any()


def _frame_ids(seed=0, b=24, k=12, n=50):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n + 1, size=(b, k)), axis=-1).astype(np.int32)
    return rng, ids, n


def test_frame_index_matches():
    _, ids, n = _frame_ids()
    a = jf.frame_index(jnp.asarray(ids), n)
    b = tf.frame_index(torch.as_tensor(ids), n)
    for f in ("perm", "rank", "seg", "rank_inv"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy(), err_msg=f)


def test_entry_col_sum_multi_values_and_grad():
    rng, ids, n = _frame_ids(1)
    vals = rng.standard_normal((3,) + ids.shape).astype(np.float32)
    ct = rng.standard_normal(vals.shape).astype(np.float32)
    ja = jf.frame_index(jnp.asarray(ids), n)
    want, vjp = jax.vjp(
        lambda v: jf.entry_col_sum_multi(v, ja.perm, ja.rank, ja.colsum_out_idx),
        jnp.asarray(vals))
    (jgrad,) = vjp(jnp.asarray(ct))
    tb = tf.frame_index(torch.as_tensor(ids), n)
    v = torch.as_tensor(vals).requires_grad_()
    got = tf.entry_col_sum_multi(v, tb.perm, tb.rank, tb.rank_inv)
    (got * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("mode", ["saverows", "prep", "nofidx"])
def test_matmul_shared_values_and_grads(mode):
    rng, ids, n = _frame_ids(2)
    h = 8
    x = rng.standard_normal((n, h)).astype(np.float32)
    vals = rng.standard_normal((2,) + ids.shape).astype(np.float32)
    vals[:, ids == n] = 0.0  # sentinel lanes are empty
    ct = rng.standard_normal((2, ids.shape[0], h)).astype(np.float32)

    def jfun(xx, vv):
        frames = [jf.CNFrame(jnp.asarray(ids), vv[i], n) for i in range(2)]
        fidx = jf.frame_index(jnp.asarray(ids), n)
        return jnp.stack(jf.matmul_shared(frames, xx, fidx))

    want, vjp = jax.vjp(jfun, jnp.asarray(x), jnp.asarray(vals))
    jdx, jdv = vjp(jnp.asarray(ct))
    xt = torch.as_tensor(x).requires_grad_()
    vt = torch.as_tensor(vals).requires_grad_()
    frames = [tf.CNFrame(torch.as_tensor(ids), vt[i], n) for i in range(2)]
    fidx = None if mode == "nofidx" else tf.frame_index(torch.as_tensor(ids), n)
    got = torch.stack(tf.matmul_shared(frames, xt, fidx, save_rows=mode == "saverows"))
    (got * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jdv), **TOL)


def test_cnframe_colsum_and_scale_match():
    rng, ids, n = _frame_ids(3)
    val = rng.standard_normal(ids.shape).astype(np.float32)
    a = jf.CNFrame(jnp.asarray(ids), jnp.asarray(val), n)
    b = tf.CNFrame(torch.as_tensor(ids), torch.as_tensor(val), n)
    np.testing.assert_allclose(b.col_sum().numpy(), np.asarray(a.col_sum()), **TOL)
    scale = rng.random(n).astype(np.float32)
    np.testing.assert_allclose(b.scale_cols(torch.as_tensor(scale)).val.numpy(),
                               np.asarray(a.scale_cols(jnp.asarray(scale)).val), **TOL)

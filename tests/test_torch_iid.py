"""Port parity: the iid sampler of gather_neighbors (sampling="iid", the
reference's with-replacement draw).  Uncapped rows are exact, so they equal
the JAX package's whatever either draws; capped rows equal it when both
are fed the same uniforms; every row is sorted by id and the deg/k weights
are unbiased."""
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

K = 8


@pytest.fixture(scope="module")
def graphs():
    """A skewed graph with hubs above K, a batch of its entries masked to 0
    (maskinput), and its A^2; target nodes cover capped, uncapped and
    isolated rows."""
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
    deg = np.diff(ip)
    nodes = np.concatenate([edges[0], np.argsort(-deg)[:16],
                            np.flatnonzero(deg == 0)[:2], np.arange(24)])
    assert (deg[nodes] > K).sum() > 16 and (deg[nodes] <= K).sum() > 16
    return {"g": (jg, tg), "a2": (ja2, ta2), "nodes": nodes, "n": n}


def _fed(monkeypatch, u):
    """torch.rand of the (B, K) shape returns the JAX package's uniforms."""
    rand = torch.rand

    def fed(*size, **kw):
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
        return torch.tensor(np.array(u)) if shape == tuple(u.shape) else rand(*size, **kw)

    monkeypatch.setattr(torch, "rand", fed)


def _both(graphs, which, key, gen):
    jg, tg = graphs[which]
    nodes = graphs["nodes"]
    a = jf.gather_neighbors(jg, jnp.asarray(nodes), K, key, sampling="iid")
    b = tf.gather_neighbors(tg, torch.as_tensor(nodes), K, gen, sampling="iid")
    return a, b, np.asarray(tg.deg[torch.as_tensor(nodes)]) > K


@pytest.mark.parametrize("which", ["g", "a2"])
def test_uncapped_rows_equal_jax(graphs, which):
    a, b, capped = _both(graphs, which, jax.random.PRNGKey(3),
                         torch.Generator().manual_seed(3))
    for field in ("ids", "w", "pos"):
        np.testing.assert_array_equal(getattr(b, field).numpy()[~capped],
                                      np.asarray(getattr(a, field))[~capped])
    assert b.ids.dtype == torch.int32 and b.w.dtype == torch.float32


@pytest.mark.parametrize("which", ["g", "a2"])
def test_capped_rows_equal_jax_on_the_same_uniforms(graphs, which, monkeypatch):
    key = jax.random.PRNGKey(11)
    _fed(monkeypatch, jax.random.uniform(key, (len(graphs["nodes"]), K)))
    a, b, capped = _both(graphs, which, key, torch.Generator().manual_seed(0))
    assert capped.sum() > 16
    for field in ("ids", "w", "pos"):
        np.testing.assert_array_equal(getattr(b, field).numpy(),
                                      np.asarray(getattr(a, field)))


def test_rows_sorted_masked_and_unbiased(graphs):
    """Each row ascending with the sentinel last; lanes on masked entries
    weigh 0; over many draws of the largest hub, the deg/k weights each
    neighbor collects average to its adjacency value."""
    _, tg = graphs["g"]
    n, nodes = graphs["n"], torch.as_tensor(graphs["nodes"])
    fr = tf.gather_neighbors(tg, nodes, K, torch.Generator().manual_seed(1),
                             sampling="iid")
    assert (fr.ids[:, 1:] >= fr.ids[:, :-1]).all()
    assert ((fr.ids == n) == (fr.w == 0)).all()
    hub = int(torch.argmax(tg.deg))
    draws = 4000
    fr = tf.gather_neighbors(tg, torch.full((draws,), hub), K,
                             torch.Generator().manual_seed(2), sampling="iid")
    start, deg = int(tg.indptr[hub]), int(tg.deg[hub])
    cols, vals = tg.col[start:start + deg], tg.val[start:start + deg]
    got = torch.zeros(n + 1).index_add_(0, fr.ids.reshape(-1).long(),
                                        fr.w.reshape(-1)) / draws
    # each lane hits a given entry with probability 1/deg, weight deg/K:
    # the mean is val with standard deviation sqrt((deg - 1) / (K * draws))
    sd = np.sqrt((deg - 1) / (K * draws))
    np.testing.assert_allclose(got[cols.long()].numpy(), vals.numpy(), atol=5 * sd)


def test_drop_keeps_the_iid_draw(graphs):
    """Lane DropAdj on top of the iid draw: the same ids, the kept weights
    scaled by 1/(1-p)."""
    _, tg = graphs["g"]
    nodes = torch.as_tensor(graphs["nodes"])
    plain = tf.gather_neighbors(tg, nodes, K, torch.Generator().manual_seed(5),
                                sampling="iid")
    dropped = tf.gather_neighbors(tg, nodes, K, torch.Generator().manual_seed(5),
                                  drop=(torch.Generator().manual_seed(6), 0.5),
                                  sampling="iid")
    assert torch.equal(plain.ids, dropped.ids)
    kept = dropped.w != 0
    torch.testing.assert_close(dropped.w[kept], 2 * plain.w[kept])

"""Port parity: the window gather (ops/window_gather.py) and the
window-table frame matmul (ops/frame.py _FrameMatmulMultiWindow).

JAX runs on the CPU, where its window_rows takes the XLA branch; the port's
wrapper takes its plain version for CPU tensors.  Rows, offsets and padded
value planes are array-equal; the frame matmul's forward, dx and dvals are
within rtol 1e-5 of jax.vjp (float32 sums over J = K + 8 lanes in another
order), and its dx equals the non-window frame matmul's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.ops import frame as jf
from ocn_tpu.ops.pallas import window_gather as JW
from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.ops import window_gather as W
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("e,h,b,k", [
    (300, 8, 40, 16),    # starts all over the table, clamped near its end
    (1000, 7, 33, 64),   # odd width
    (5, 3, 6, 4),        # E < J: every window clamps at the last row
])
def test_window_rows_plain_matches(e, h, b, k):
    rng = np.random.default_rng(e)
    y = rng.standard_normal((e, h)).astype(np.float32)
    # window starts as gather_neighbors clamps them: pos0 <= E - K
    pos0 = rng.integers(0, max(e - k, 0) + 1, size=b).astype(np.int32)
    pos0[:2] = [0, max(e - k, 0)]
    want_rows, want_off = JW.window_rows(jnp.asarray(y), jnp.asarray(pos0), k)
    before = W.window_rows.launches
    rows, off = W.window_rows(torch.as_tensor(y), torch.as_tensor(pos0), k)
    assert W.window_rows.launches == before  # CPU tensors: the plain version
    assert rows.shape == (b, k + W.SLACK, h)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))
    for got, want in zip(W.aligned_starts(torch.as_tensor(pos0), e, k),
                         JW.aligned_starts(jnp.asarray(pos0), e, k)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ((off >= 0) & (off <= W.SLACK)).all()


def test_pad_vals_matches():
    rng = np.random.default_rng(0)
    p, b, k = 2, 30, 12
    vals = rng.standard_normal((p, b, k)).astype(np.float32)
    off = rng.integers(0, W.SLACK + 1, size=b).astype(np.int32)
    want = JW.pad_vals(jnp.asarray(vals), jnp.asarray(off), k + W.SLACK)
    got = W.pad_vals(torch.as_tensor(vals), torch.as_tensor(off), k + W.SLACK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def frame_inputs():
    """One chunk's candidate frames on a Zipf-skewed graph: ids, CSR window
    positions, two value planes (zero on empty lanes), node features x and
    the window table y = x[col]."""
    ds = synthetic_dataset("Cora", seed=4, scale=0.15)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    tg = tgraph(ip, col, n)
    rng = np.random.default_rng(1)
    hubs = np.argsort(ip[1:] - ip[:-1])[-8:]
    nodes = np.concatenate([rng.integers(0, n, size=40), hubs])
    k, h = 16, 8
    src = tf.gather_neighbors(tg, torch.as_tensor(nodes), k,
                              torch.Generator().manual_seed(0))
    ids, pos = src.ids.numpy(), src.pos.numpy()
    vals = rng.standard_normal((2,) + ids.shape).astype(np.float32)
    vals[:, ids == n] = 0.0
    x = rng.standard_normal((n, h)).astype(np.float32)
    y = x[tg.col.numpy()]
    ct = rng.standard_normal((2, ids.shape[0], h)).astype(np.float32)
    assert (src.w.numpy() > 1).any()  # capped rows with sampled windows
    return dict(ids=ids, pos=pos, vals=vals, x=x, y=y, ct=ct, n=n)


def _torch_window(fi, x, vals):
    ids = torch.as_tensor(fi["ids"])
    frames = [tf.CNFrame(ids, vals[i], fi["n"]) for i in range(2)]
    fidx = tf.frame_index(ids, fi["n"])
    return torch.stack(tf.matmul_shared(
        frames, x, fidx, y=torch.as_tensor(fi["y"]), pos=torch.as_tensor(fi["pos"])))


def test_window_frame_matmul_matches_jax_vjp(frame_inputs):
    fi = frame_inputs
    n = fi["n"]
    ids = jnp.asarray(fi["ids"])
    ja = jf.frame_index(ids, n)

    def jfun(xx, vv):
        return jf._frame_matmul_multi_window(
            xx, jnp.asarray(fi["y"]), jnp.asarray(fi["pos"]), ids, vv,
            ja.perm, ja.seg, n)

    want, vjp = jax.vjp(jfun, jnp.asarray(fi["x"]), jnp.asarray(fi["vals"]))
    jdx, jdv = vjp(jnp.asarray(fi["ct"]))
    xt = torch.as_tensor(fi["x"]).requires_grad_()
    vt = torch.as_tensor(fi["vals"]).requires_grad_()
    got = _torch_window(fi, xt, vt)
    (got * torch.as_tensor(fi["ct"])).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jdv), **TOL)


def test_window_frame_matmul_equals_the_row_gather(frame_inputs):
    """Same values and the same dx as the (B, K, H) row-gather path; dvals
    only where the lane is real (empty lanes read other rows of y)."""
    fi = frame_inputs
    ct = torch.as_tensor(fi["ct"])
    grads = {}
    for mode in ("window", "rows"):
        xt = torch.as_tensor(fi["x"]).requires_grad_()
        vt = torch.as_tensor(fi["vals"])
        if mode == "window":
            out = _torch_window(fi, xt, vt)
        else:
            ids = torch.as_tensor(fi["ids"])
            frames = [tf.CNFrame(ids, vt[i], fi["n"]) for i in range(2)]
            out = torch.stack(tf.matmul_shared(
                frames, xt, tf.frame_index(ids, fi["n"])))
        (out * ct).sum().backward()
        grads[mode] = (out.detach(), xt.grad)
    torch.testing.assert_close(grads["window"][0], grads["rows"][0], **TOL)
    assert torch.equal(grads["window"][1], grads["rows"][1])


def test_window_frame_matmul_rejects_scattered_positions(frame_inputs):
    fi = dict(frame_inputs)
    pos = fi["pos"].copy()
    pos[3, 5] += 1
    fi["pos"] = pos
    with pytest.raises(ValueError, match="contiguous windows"):
        _torch_window(fi, torch.as_tensor(fi["x"]), torch.as_tensor(fi["vals"]))


def test_cn_frames_with_src_matches():
    """cn_frames(with_src=True) hands back the candidate frame whose CSR
    positions feed the window path, equal to the JAX one."""
    ds = synthetic_dataset("Cora", seed=4, scale=0.15)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    ip2, col2, val2 = B.adj2_csr(ip, col, n, cap=48)
    tar = ds.split_edge["train"]["edge"][:32].T
    a = jf.cn_frames(jgraph(ip, col, n), jnp.asarray(tar), k=16, k2=16,
                     adj2=jgraph(ip2, col2, n, val2, gather_only=True),
                     with_src=True)
    b = tf.cn_frames(tgraph(ip, col, n), torch.as_tensor(tar), k=16, k2=16,
                     adj2=tgraph(ip2, col2, n, val2, gather_only=True),
                     with_src=True)
    assert len(b) == 3
    for f in ("ids", "w", "pos"):
        np.testing.assert_array_equal(getattr(b[2], f).numpy(),
                                      np.asarray(getattr(a[2], f)), err_msg=f)
    np.testing.assert_allclose(b[1].val.numpy(), np.asarray(a[1].val), **TOL)

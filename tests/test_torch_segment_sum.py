"""Port parity: the sorted segment sum (ops/segment_sum.py) and the sites that
run through it, against the JAX package's jax.ops.segment_sum (rtol=1e-5,
atol=1e-6 in float32; one bfloat16 ulp where the output is bfloat16).

On the CPU the wrapper runs its plain version (index_add_ in index order);
the CUDA kernel is held against that plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.  The last test is a guard: a
bench-shaped cn5 step and eval and a cn3 step, under a dispatch mode, call
no scatter-add (index_add, scatter_add, scatter_reduce with sum or mean)
outside the wrapper, whose own plain version the mode can tell by
``segment_sum.active()``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from chip_rehearsal import TINY, on_cpu  # noqa: F401 (fixture)
from ocn_tpu.ops import frame as jf
from ocn_tpu.ops import spmm as jspmm
from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.ops import segment_sum as SS
from ocn_tpu_torch.ops import spmm as tspmm
from ocn_tpu_torch.sparse.build import csr_from_edge_index
from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

TOL = dict(rtol=1e-5, atol=1e-6)


def _ragged(rng, nseg, n_src, h, hub=0, lead=0, tail=0):
    """Offsets of ragged segments (a third empty, one of ``hub`` entries),
    ``lead`` entries before the first and ``tail`` after the last, with rows
    and scales for every entry."""
    lens = rng.integers(1, 9, size=nseg) * (rng.random(nseg) > 0.33)
    if hub:
        lens[nseg // 2] = hub
    off = lead + np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    q = int(off[-1]) + tail
    idx = rng.integers(0, n_src, size=q)
    src = rng.standard_normal((n_src, h)).astype(np.float32)
    scale = rng.standard_normal(q).astype(np.float32)
    return off, idx, src, scale


def _entry_segments(off, q):
    """Each entry's segment for JAX, len(off) - 1 (dropped) outside them."""
    seg = np.full(q, len(off) - 1, np.int64)
    for s in range(len(off) - 1):
        seg[off[s]:off[s + 1]] = s
    return seg


def _jax_sum(src, off, idx, scale):
    q = len(idx) if idx is not None else src.shape[0]
    rows = jnp.asarray(src)[jnp.asarray(idx)] if idx is not None else jnp.asarray(src)
    if scale is not None:
        rows = jnp.asarray(scale)[:, None] * rows
    return np.asarray(jax.ops.segment_sum(
        rows, jnp.asarray(_entry_segments(off, q)), num_segments=len(off) - 1,
        indices_are_sorted=True))


@pytest.mark.parametrize("h,idx_dtype,scaled,src_dtype,hub,lead,tail", [
    (1, None, False, "float32", 0, 0, 0),          # row sums, contiguous rows
    (1, "int64", True, "float32", 0, 0, 0),
    (8, "int32", True, "float32", 0, 0, 0),        # the SpMM's form
    (64, "int64", False, "float32", 300, 0, 0),    # a hub row
    (5, "int64", False, "float32", 0, 3, 7),       # entries outside every segment
    (16, "int32", True, "bfloat16", 0, 0, 0),      # bfloat16 rows, float32 out
    (16, None, False, "bfloat16", 40, 0, 0),       # bfloat16 out
])
def test_plain_matches_jax(h, idx_dtype, scaled, src_dtype, hub, lead, tail):
    rng = np.random.default_rng(h + hub + lead)
    off, idx, src, scale = _ragged(rng, 40, 30, h, hub, lead, tail)
    if idx_dtype is None:
        src = rng.standard_normal((len(idx), h)).astype(np.float32)
        idx = None
    src_t = torch.as_tensor(src).to(getattr(torch, src_dtype))
    src32 = src_t.float().numpy()  # the values both sides sum
    got = SS.segment_sum(
        src_t, torch.as_tensor(off),
        None if idx is None else torch.as_tensor(idx).to(getattr(torch, idx_dtype)),
        torch.as_tensor(scale) if scaled else None)
    want = _jax_sum(src32, off, idx, scale if scaled else None)
    assert got.shape == want.shape
    assert got.dtype == (torch.float32 if scaled else src_t.dtype)
    if got.dtype == torch.bfloat16:
        # one rounding of the float32 sum
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    empty = off[1:] == off[:-1]
    assert empty.any() and (got.float().numpy()[empty] == 0).all()


def test_subnormal_sums_flush_to_zero_like_jax():
    """Subnormal terms and sums flush to zero, as XLA's sums do (and the
    card's atomics did): a column sum of underflowing probabilities is 0,
    which the incomplete family's 1 / colsum guards, not 7e-39."""
    vals = np.array([3e-39, 4e-39, 1.0, -1.0, 2e-30, 3e-30], np.float32)
    off = np.array([0, 2, 4, 6])
    want = _jax_sum(vals[:, None], off, None, None)[:, 0]
    got = SS.segment_sum(torch.as_tensor(vals), torch.as_tensor(off))
    np.testing.assert_array_equal(want[:2], [0.0, 0.0])
    np.testing.assert_array_equal(got.numpy(), want)


def test_one_dimensional_and_strided_rows():
    """1-D values give (S,) sums; a transposed (M, P) view of (P, M) planes
    is read through its strides, as the column sums read them."""
    rng = np.random.default_rng(3)
    off, idx, _, _ = _ragged(rng, 25, 60, 1)
    planes = rng.standard_normal((3, 60)).astype(np.float32)
    got = SS.segment_sum(torch.as_tensor(planes).T, torch.as_tensor(off),
                         torch.as_tensor(idx))
    np.testing.assert_allclose(got.numpy(), _jax_sum(planes.T, off, idx, None), **TOL)
    got1 = SS.segment_sum(torch.as_tensor(planes[0]), torch.as_tensor(off),
                          torch.as_tensor(idx))
    np.testing.assert_allclose(got1.numpy(), got.numpy()[:, 0], rtol=0, atol=0)


def test_gradients_match_jax_vjp():
    """d src (a keyed sum over idx) and d scale (row dots) against JAX's
    autodiff of the same segment sum."""
    rng = np.random.default_rng(5)
    off, idx, src, scale = _ragged(rng, 30, 20, 6, hub=50, tail=4)
    ct = rng.standard_normal((30, 6)).astype(np.float32)
    seg = jnp.asarray(_entry_segments(off, len(idx)))

    def jfun(s, w):
        rows = w[:, None] * s[jnp.asarray(idx)]
        return jax.ops.segment_sum(rows, seg, num_segments=30, indices_are_sorted=True)

    want, vjp = jax.vjp(jfun, jnp.asarray(src), jnp.asarray(scale))
    jds, jdw = vjp(jnp.asarray(ct))
    st = torch.as_tensor(src).requires_grad_()
    wt = torch.as_tensor(scale).requires_grad_()
    got = SS.segment_sum(st, torch.as_tensor(off), torch.as_tensor(idx), wt)
    (got * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jds), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)


def test_keyed_sum_and_gradient_match_jax():
    """segment_sum_by over unsorted keys, and its VJP (a gather)."""
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 17, size=200)
    src = rng.standard_normal((200, 3)).astype(np.float32)
    ct = rng.standard_normal((17, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda s: jax.ops.segment_sum(s, jnp.asarray(keys), 17),
                        jnp.asarray(src))
    st = torch.as_tensor(src).requires_grad_()
    got = SS.segment_sum_by(st, torch.as_tensor(keys), 17)
    (got * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), **TOL)
    perm, off = SS.sort_segments(torch.as_tensor(keys), 17)
    assert torch.equal(torch.as_tensor(keys)[perm],
                       torch.as_tensor(np.sort(keys, kind="stable")))
    assert off[0] == 0 and off[-1] == 200


@pytest.mark.parametrize("symmetric", [True, False])
def test_spmm_forward_and_vjp_match_jax(symmetric):
    """The encoder's SpMM through the wrapper: forward, dx and dval against
    the JAX package's one-shot path (its blocked path is not reached at
    this size).  A symmetric pattern takes the transpose-permutation
    backward; a directed one the wrapper's own VJP."""
    rng = np.random.default_rng(7)
    n, h = 50, 8
    dense = rng.random((n, n)) < 0.12
    np.fill_diagonal(dense, False)
    if symmetric:
        dense = np.triu(dense, 1)
        dense = dense | dense.T
    ip, col = csr_from_edge_index(np.stack(np.nonzero(dense)), n, symmetrize=False)
    val = rng.random(col.shape[0]).astype(np.float32)
    jg, tg = jgraph(ip, col, n, val), tgraph(ip, col, n, val)
    assert (tg.tpos is not None) == symmetric
    x = rng.standard_normal((n, h)).astype(np.float32)
    ct = rng.standard_normal((n, h)).astype(np.float32)
    vals = np.array(jg.val)

    def jfun(xx, vv):
        return jspmm.spmm(jg.with_values(vv), xx, "sum")

    want, vjp = jax.vjp(jfun, jnp.asarray(x), jnp.asarray(vals))
    jdx, jdv = vjp(jnp.asarray(ct))
    xt = torch.as_tensor(x).requires_grad_()
    vt = torch.as_tensor(vals).requires_grad_()
    got = tspmm.spmm(tg.with_values(vt), xt, "sum")
    (got * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jdv), **TOL)
    np.testing.assert_allclose(tg.value_rowsum().numpy(),
                               np.asarray(jg.value_rowsum()), **TOL)


def _sentinel_frame(seed, b=40, k=16, n=30):
    """Sorted frame ids with most lanes on the sentinel n (the giant segment
    of the frames' column sums and dx), values zero there."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 5, size=b)
    ids = np.full((b, k), n, np.int32)
    for r in range(b):
        ids[r, :deg[r]] = np.sort(rng.choice(n, deg[r], replace=False))
    assert (ids == n).mean() > 0.7
    return rng, ids, n


def test_entry_col_sum_multi_matches_jax():
    """The frames' column sums over the FrameIndex offsets, values and the
    self-adjoint VJP; the sentinel's segment holds most entries."""
    rng, ids, n = _sentinel_frame(8)
    vals = rng.standard_normal((3,) + ids.shape).astype(np.float32)
    ct = rng.standard_normal(vals.shape).astype(np.float32)
    ja = jf.frame_index(jnp.asarray(ids), n)
    want, vjp = jax.vjp(
        lambda v: jf.entry_col_sum_multi(v, ja.perm, ja.rank, ja.colsum_out_idx),
        jnp.asarray(vals))
    (jgrad,) = vjp(jnp.asarray(ct))
    tb = tf.frame_index(torch.as_tensor(ids), n)
    assert tb.rank_off.shape == (ids.size + 1,) and tb.seg_off.shape == (n + 1,)
    v = torch.as_tensor(vals).requires_grad_()
    got = tf.entry_col_sums(v, tb)
    (got * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrad), **TOL)
    # without the offsets, entry_col_sum_multi finds them from rank
    again = tf.entry_col_sum_multi(torch.as_tensor(vals), tb.perm, tb.rank, tb.rank_inv)
    assert torch.equal(again, got.detach())


@pytest.mark.parametrize("with_index", [True, False])
def test_frame_matmul_dx_matches_jax(with_index):
    """The frame matmul's dx (the sorted segment sum over seg_off, the
    sentinel lanes in node n - 1 as in JAX) and dvals against JAX's VJP,
    with the FrameIndex's sort and with the backward's own."""
    rng, ids, n = _sentinel_frame(9)
    h = 8
    x = rng.standard_normal((n, h)).astype(np.float32)
    vals = rng.standard_normal((2,) + ids.shape).astype(np.float32)
    vals[:, ids == n] = 0.0
    ct = rng.standard_normal((2, ids.shape[0], h)).astype(np.float32)

    def jfun(xx, vv):
        frames = [jf.CNFrame(jnp.asarray(ids), vv[i], n) for i in range(2)]
        return jnp.stack(jf.matmul_shared(frames, xx, jf.frame_index(jnp.asarray(ids), n)))

    want, vjp = jax.vjp(jfun, jnp.asarray(x), jnp.asarray(vals))
    jdx, jdv = vjp(jnp.asarray(ct))
    xt = torch.as_tensor(x).requires_grad_()
    vt = torch.as_tensor(vals).requires_grad_()
    frames = [tf.CNFrame(torch.as_tensor(ids), vt[i], n) for i in range(2)]
    fidx = tf.frame_index(torch.as_tensor(ids), n) if with_index else None
    got = torch.stack(tf.matmul_shared(frames, xt, fidx))
    (got * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jdv), **TOL)


def test_cnframe_col_sum_and_gradient_match_jax():
    rng, ids, n = _sentinel_frame(10)
    val = rng.standard_normal(ids.shape).astype(np.float32)
    ct = rng.standard_normal(n).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jf.CNFrame(jnp.asarray(ids), v, n).col_sum(),
                        jnp.asarray(val))
    vt = torch.as_tensor(val).requires_grad_()
    got = tf.CNFrame(torch.as_tensor(ids), vt, n).col_sum()
    (got * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), **TOL)


# scatter-adds: atomic on the card; only the wrapper's plain version may run one
SCATTER_ADDS = {"index_add", "index_add_", "scatter_add", "scatter_add_"}
SCATTER_REDUCES = {"scatter_reduce", "scatter_reduce_"}


class ScatterGuard(TorchDispatchMode):
    """Records every aten op, and each scatter-add outside segment_sum."""

    def __init__(self):
        super().__init__()
        self.ops = set()
        self.outside = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.ops.add(name)
        reduce = kwargs.get("reduce", args[4] if len(args) > 4 else None)
        summed = name in SCATTER_ADDS or (
            name in SCATTER_REDUCES and reduce in ("sum", "mean"))
        if summed and not SS.active():
            self.outside.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("program", ["cn5_bench", "cn3_family"])
def test_no_scatter_add_outside_segment_sum(on_cpu, program):
    """bench_slice's program (cn5: ELL tables, k_small 16, frame groups,
    bfloat16 x) at a tiny size, one step and one evaluate, and one step of
    family_slice's cn3: every scatter-add, forward and backward, is the
    wrapper's own."""
    from ocn_tpu_torch.train.loop import Trainer

    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    if program == "cn5_bench":
        cfg = chip_smoke.slice_config(**{**chip_smoke.BENCH_PATH, **TINY})
    else:
        cfg = chip_smoke.slice_config(**{**chip_smoke.FAMILY_PATH, "predictor": "cn3",
                                         **TINY})
        ds = chip_smoke.family_cut(ds, cfg.batch_size, 1)
    tr = Trainer(cfg, ds, device="cpu")
    state = tr.init_state(0)
    tr._refresh_ell(np.random.default_rng(1))
    pos, neg, batches = chip_smoke.step_batches(tr, ds, nsteps=1)
    gen = torch.Generator().manual_seed(0)
    guard = ScatterGuard()
    with guard:
        state, _, losses = chip_smoke.run_steps(tr, state, pos, neg, batches, gen)
        if program == "cn5_bench":
            chip_smoke.check_hits(tr.evaluate(state))
    assert np.isfinite(losses).all()
    assert guard.outside == []
    # the wrapper ran (its plain version's index_add_), and so did backward ops
    assert "index_add_" in guard.ops and "searchsorted" in guard.ops
    assert any(name.endswith("_backward") for name in guard.ops)

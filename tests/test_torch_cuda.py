"""The port on the card: the CUDA membership, window-gather, row-gather,
sorted-block-gather, segment-sum and negatives kernels against their plain
versions (and the negatives against the native host sampler),
and the kernels' callers on CUDA tensors against the same calls on CPU
tensors (the grouped bfloat16 steps among them), and two runs of one seed
on the card against each other, bit for bit.  Every test here is marked ``cuda``
and skips without a GPU.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import types

import numpy as np
import pytest
import torch

from ocn_tpu_torch.config import Config
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.ops import membership as tm
from ocn_tpu_torch.ops import negatives as tneg
from ocn_tpu_torch.ops import row_gather as trg
from ocn_tpu_torch.ops import segment_sum as tss
from ocn_tpu_torch.ops import window_gather as tw
from ocn_tpu_torch.scripts import bench_gather as G
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse.csr import graph_from_numpy
from ocn_tpu_torch.train.loop import Trainer
from ocn_tpu_torch.utils import native, profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(rng, lead, kq, ks, n, unit_w):
    q = rng.integers(0, n, size=lead + (kq,)).astype(np.int32)
    ids = np.sort(rng.integers(0, n, size=lead + (ks,)), axis=-1).astype(np.int32)
    w = (np.ones(lead + (ks,), np.float32) if unit_w
         else rng.random(lead + (ks,)).astype(np.float32))
    return q, ids, w


@pytest.mark.parametrize("lead,kq,ks,n,unit_w", [
    ((4096,), 64, 64, 235868, False),   # cn1/cn2 at the main-path chunk
    ((32768,), 64, 64, 235868, False),  # a frame group of 8 chunks
    ((300,), 16, 32, 77, True),         # ragged rows, many duplicates
    ((64, 8), 64, 16, 500, True),       # (B, R, K) leading dims
    ((100,), 4, 1500, 50, False),       # Ks past one shared-memory tile
    # Kq in {1, 3, 16, 64} by Ks in {1, 5, 16, 64, 600}, B not a multiple
    # of a block's rows (256, 256, 64, 16), duplicates exact at unit weights
    ((1001,), 1, 1, 3, True),
    ((1001,), 1, 600, 40, True),
    ((1001,), 3, 5, 7, True),
    ((1001,), 3, 600, 100, False),
    ((1001,), 16, 16, 20, True),
    ((1001,), 16, 64, 50, False),
    ((1001,), 64, 5, 9, True),
    ((1001,), 64, 64, 80, True),
    ((77, 5), 16, 600, 500, True),      # (B, R, K) with Ks past one tile
    ((517,), 16, 2000, 300, True),      # Kq*Ks = 32,000, near the limit
    ((333,), 64, 500, 200, False),      # Kq*Ks = 32,000 at Kq = 64
    # the shapes of the hoisted step (2 * 65536 rows) and of cn6's chunks
    # (its third lookup against 16 lanes of A^3), exact with unit weights
    ((131072,), 64, 64, 3000, True),
    ((4096,), 64, 16, 300, True),
    ((4096,), 16, 16, 300, True),
])
def test_membership_kernel_matches_plain(cuda, lead, kq, ks, n, unit_w):
    q, ids, w = (torch.as_tensor(a, device=cuda) for a in
                 _inputs(np.random.default_rng(0), lead, kq, ks, n, unit_w))
    before = tm.membership_counts.launches
    shape = (int(np.prod(lead)), kq, ks)
    shapes_before = tm.membership_counts.shapes[shape]
    got = tm.membership_counts(q, ids, w)
    torch.cuda.synchronize()
    assert tm.membership_counts.launches == before + 1
    assert tm.membership_counts.shapes[shape] == shapes_before + 1
    want = tm.membership_counts_plain(q, ids, w)
    if unit_w:  # sums of ones are exact
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def test_membership_wrapper_rejects(cuda):
    q, ids, w = (torch.as_tensor(a, device=cuda) for a in
                 _inputs(np.random.default_rng(1), (8,), 4, 4, 10, True))
    with pytest.raises(TypeError):
        tm.membership_counts(q.long(), ids, w)
    with pytest.raises(ValueError, match="contiguous"):
        tm.membership_counts(q.t().contiguous().t(), ids, w)
    with pytest.raises(ValueError, match="one CUDA device"):
        tm.membership_counts(q, ids.cpu(), w)


def test_cn_frames_on_the_card_match_cpu(cuda):
    ds = synthetic_dataset("Cora", seed=4, scale=0.2)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    ip2, col2, val2 = B.adj2_csr(ip, col, n, cap=256)
    tar = ds.split_edge["train"]["edge"][:200].T
    out = {}
    for dev in ("cpu", cuda):
        g = graph_from_numpy(ip, col, n).to(dev)
        a2 = graph_from_numpy(ip2, col2, n, val2, gather_only=True).to(dev)
        before = tm.membership_counts.launches
        cn1, cn2 = tf.cn_frames(g, torch.as_tensor(tar, device=dev), k=32, k2=64,
                                adj2=a2, k2_dst=16)
        out[str(dev)] = (cn1.val.cpu(), cn2.val.cpu())
        assert tm.membership_counts.launches == before + (2 if dev == cuda else 0)
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)  # unit adjacency values: exact


def test_cn3_frame_on_the_card_matches_cpu(cuda):
    """cn6's third frame on the A^3 path (a capped A^3, rows wider than the
    16-lane gather take their first window), card against CPU: exact."""
    ds = synthetic_dataset("Cora", seed=4, scale=0.2)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    ip2, col2, val2 = B.adj2_csr(ip, col, n, cap=256)
    n2 = int(ip2[-1])
    ip3, col3, val3 = B.spgemm_csr(ip2, col2[:n2], val2[:n2], ip, col, None, n, cap=64)
    assert int(np.diff(ip3).max()) > 16
    tar = ds.split_edge["train"]["edge"][:300].T
    out = {}
    for dev in ("cpu", cuda):
        g = graph_from_numpy(ip, col, n).to(dev)
        a3 = graph_from_numpy(ip3, col3, n, val3, gather_only=True).to(dev)
        t = torch.as_tensor(tar, device=dev)
        src = tf.gather_neighbors(g, t[0], 32)
        before = tm.membership_counts.launches
        cn3 = tf.cn3_frame(g, t, src, k2=16, k3=16, adj3=a3)
        assert tm.membership_counts.launches == before + (1 if dev == cuda else 0)
        out[str(dev)] = cn3.val.cpu()
    assert torch.equal(out["cpu"], out["cuda"]) and (out["cpu"] != 0).any()


TRAIN_KW = dict(model="gcn", mplayers=2, hiddim=32, ln=True, res=True, jk=True,
                use_xlin=True, tailact=True, gnndp=0.0, xdp=0.0, tdp=0.0,
                gnnedp=0.0, predp=0.0, preedp=0.0, maskinput=True,
                batch_size=128, linkbatchsize=64, testbs=256, pad_deg=64,
                pad_deg2=256, ell_tables=False, k_small=0)


def _epoch_losses(cfg, ds, dev, check):
    tr = Trainer(cfg, ds, device=dev)
    check(tr)
    state = tr.init_state(0)
    rng = np.random.default_rng(0)
    return [tr.train_epoch(state, rng, ep)[1] for ep in (1, 2)]


def test_train_steps_on_the_card_match_cpu(cuda):
    ds = synthetic_dataset("Cora", seed=0, scale=0.2).reorder_bfs()
    cfg = Config(**TRAIN_KW)

    def check(tr):
        assert int(tr.g.deg.max()) <= cfg.pad_deg
        assert int(tr.adj2.deg.max()) <= cfg.pad_deg2

    losses = {dev: _epoch_losses(cfg, ds, dev, check) for dev in ("cpu", "cuda")}
    # float32 sums in another order on the card (no TF32: matmuls are full
    # float32 by default); the difference compounds over the steps
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def _window_starts(gen, e, b, k, itype, cuda):
    """b window starts in [0, E - K] as ops/frame.py passes them (int64:
    column 0 of the (B, K) positions, a strided view), with the edge cases
    first: the first row, the last start (whose aligned start clamps to
    E - J) and starts in the last 8 rows, where off != pos0 mod 8."""
    top = max(e - k, 0)
    pos = (torch.randint(0, top + 1, (b, 1), generator=gen, device=cuda,
                         dtype=itype)
           + torch.arange(k, device=cuda, dtype=itype))
    pos0 = pos[:, 0] if itype == torch.int64 else pos[:, 0].contiguous()
    edge = [0, top, max(top - 1, 0), max(top - 3, 0), max(top - 7, 0)][:b]
    pos0[:len(edge)] = torch.tensor(edge, device=cuda, dtype=itype)
    return pos0


@pytest.mark.parametrize("e,h,b,k,dtype,itype", [
    (1_324_714, 256, 4096, 64, torch.float32, torch.int32),   # the big body
    (1_324_714, 256, 4096, 64, torch.float32, torch.int64),
    (1_324_714, 256, 4096, 16, torch.float32, torch.int32),   # the small body
    (1_324_714, 256, 4096, 16, torch.float32, torch.int64),
    (1_324_714, 256, 65536, 64, torch.float32, torch.int64),  # the eval batch
    (1_324_714, 256, 4096, 64, torch.bfloat16, torch.int32),  # gather_w
    (1_324_714, 256, 4096, 16, torch.bfloat16, torch.int64),
    (20000, 256, 200_000, 16, torch.float32, torch.int64),    # 10 windows a table row
    (5, 7, 6, 4, torch.float32, torch.int32),    # E < J: every window clamps
    (5, 256, 6, 4, torch.float32, torch.int64),  # E < J at 16-byte rows
    (1000, 33, 100, 16, torch.bfloat16, torch.int32),  # 2-byte units
    (300, 13, 50, 8, torch.uint8, torch.int64),        # byte units
])
def test_window_rows_kernel_matches_plain(cuda, e, h, b, k, dtype, itype):
    gen = torch.Generator(device=cuda).manual_seed(e + k)
    y = torch.randn((e, h), generator=gen, device=cuda).to(dtype)
    pos0 = _window_starts(gen, e, b, k, itype, cuda)
    before = tw.window_rows.launches
    rows, off = tw.window_rows(y, pos0, k)
    torch.cuda.synchronize()
    assert tw.window_rows.launches == before + 1
    want, want_off = tw.window_rows_plain(y, pos0, k)
    assert rows.shape == (b, k + tw.SLACK, h)
    assert torch.equal(rows, want) and torch.equal(off, want_off)  # a copy
    assert off.dtype == torch.int32
    assert torch.equal(off, tw.aligned_starts(pos0, e, k)[1])


@pytest.mark.parametrize("itype", [torch.int32, torch.int64])
def test_window_rows_is_one_device_kernel(cuda, itype):
    """A call on the card is one device kernel: the start arithmetic runs
    in it, and the strided int64 starts are read as given."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    y = torch.randn((100_000, 256), generator=gen, device=cuda)
    pos0 = _window_starts(gen, 100_000, 4096, 64, itype, cuda)
    call = lambda: tw.window_rows(y, pos0, 64)  # noqa: E731
    call()  # the library is built and loaded outside the profile
    torch.cuda.synchronize()
    activities = profiling.profile_calls(call, 1)
    assert ["window_rows_kernel" in name for name, _, _ in activities] == [True]


def test_window_rows_unaligned_table(cuda):
    flat = torch.randn(2000 * 64 + 1, device=cuda)
    y = flat[1:].view(2000, 64)  # 4 bytes off 16-byte alignment
    pos0 = torch.randint(0, 2000 - 32, (300,), device=cuda)
    rows, off = tw.window_rows(y, pos0, 32)
    want, want_off = tw.window_rows_plain(y, pos0, 32)
    assert torch.equal(rows, want) and torch.equal(off, want_off)
    # still one kernel, on 4-byte units
    activities = profiling.profile_calls(lambda: tw.window_rows(y, pos0, 32), 1)
    assert ["window_rows_kernel" in n for n, _, _ in activities] == [True]


def test_queued_device_ms_hides_the_host(cuda):
    """Behind the spin, the card runs the calls back to back: a short
    kernel's device time is below the wrapper's per-call time, and a call
    that launches the kernel twice takes about twice as long."""
    q, ids, w = (torch.as_tensor(a, device=cuda) for a in
                 _inputs(np.random.default_rng(0), (4096,), 64, 64, 1000, False))
    once = profiling.queued_device_ms(lambda: tm.membership_counts(q, ids, w))
    twice = profiling.queued_device_ms(
        lambda: (tm.membership_counts(q, ids, w), tm.membership_counts(q, ids, w)))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(200):
        tm.membership_counts(q, ids, w)
    end.record()
    torch.cuda.synchronize()
    assert 0 < once < start.elapsed_time(end) / 200
    assert 1.5 * once < twice < 2.5 * once


def test_window_rows_wrapper_rejects(cuda):
    y = torch.randn(100, 8, device=cuda)
    pos0 = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tw.window_rows(y, pos0.float(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        tw.window_rows(y.t().contiguous().t(), pos0, 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        tw.window_rows(y, pos0.cpu(), 8)


def test_window_path_steps_on_the_card_match_cpu(cuda):
    """ELL tables, the dual-K split and the window table: capped rows ride
    the tables, whose offsets come from NumPy, so no random stream is read."""
    ds = synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()
    cfg = Config(**dict(TRAIN_KW, batch_size=256, linkbatchsize=32, pad_deg=32,
                        pad_deg2=16, ell_tables=True, k_small=8,
                        window_table=True))

    def check(tr):
        assert tr._use_ell and tr._split and min(tr._split) > 0
        assert int(tr.g.deg.max()) > cfg.pad_deg

    before = tw.window_rows.launches
    losses = {"cpu": _epoch_losses(cfg, ds, "cpu", check)}
    assert tw.window_rows.launches == before
    losses["cuda"] = _epoch_losses(cfg, ds, "cuda", check)
    # one launch per chunk: two epochs of whole batches
    steps = ds.split_edge["train"]["edge"].shape[0] // cfg.batch_size
    chunks = 2 * cfg.batch_size // cfg.linkbatchsize
    assert tw.window_rows.launches - before == 2 * steps * chunks
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("n,h,m,dtype,itype,sort", [
    (235868, 256, 262144, torch.bfloat16, torch.int32, False),  # the instrument
    (235868, 256, 262144, torch.bfloat16, torch.int32, True),
    (235868, 256, 262144, torch.float32, torch.int64, False),
    (1000, 33, 4097, torch.bfloat16, torch.int32, False),  # 2-byte units, ragged M
    (300, 13, 1001, torch.float32, torch.int64, False),    # 4-byte units
    (50, 3, 77, torch.uint8, torch.int32, False),          # byte units, 4 a row
])
def test_row_rows_kernel_matches_plain(cuda, n, h, m, dtype, itype, sort):
    gen = torch.Generator(device=cuda).manual_seed(n + m)
    x = (torch.randint(0, 255, (n, h), generator=gen, device=cuda, dtype=dtype)
         if dtype == torch.uint8 else
         torch.randn((n, h), generator=gen, device=cuda).to(dtype))
    idx = torch.randint(0, n, (m,), generator=gen, device=cuda, dtype=itype)
    idx[3], idx[4] = n + 5, -2  # clamped into [0, n)
    if sort:
        idx = torch.sort(idx).values
    before = trg.row_rows.launches
    got = trg.row_rows(x, idx)
    torch.cuda.synchronize()
    assert trg.row_rows.launches == before + 1
    assert torch.equal(got, trg.row_rows_plain(x, idx))  # a copy


def test_sorted_block_rows_kernel_matches_plain(cuda):
    s = G.SIZES
    idx = np.sort(np.random.default_rng(0).integers(0, s["n"], size=s["m"]))
    bases = G.tile_bases(idx, s["n"], s["ts"], s["w"])
    x = torch.randn((s["n"], s["h"]), device=cuda).bfloat16()
    ids = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    tb = torch.as_tensor(bases, device=cuda)
    before = trg.sorted_block_rows.launches
    got = trg.sorted_block_rows(x, ids, tb, s["ts"], s["w"])
    torch.cuda.synchronize()
    assert trg.sorted_block_rows.launches == before + 1
    assert torch.equal(got, trg.sorted_block_rows_plain(x, ids, tb, s["ts"], s["w"]))
    assert torch.equal(got, torch.index_select(x, 0, ids))  # all in their blocks
    # ids outside their blocks, a ragged last tile clamped at n - w, int64
    n, ts, w = 3000, 64, 320
    small = np.sort(np.random.default_rng(1).integers(0, n, size=1297))
    small[-40:] = np.sort(np.random.default_rng(2).integers(n - 30, n, size=40))
    b = G.tile_bases(small, n, ts, w)
    small[70], small[130] = b[1] + w + 3, b[2] - 2
    x2 = torch.randn((n, 256), device=cuda).bfloat16()
    ids2 = torch.as_tensor(small, device=cuda)
    b2 = torch.as_tensor(b, dtype=torch.int64, device=cuda)
    got = trg.sorted_block_rows(x2, ids2, b2, ts, w)
    assert torch.equal(got, trg.sorted_block_rows_plain(x2, ids2, b2, ts, w))
    assert not got[70].any() and not got[130].any() and got[71].any()


def test_row_gather_wrappers_reject(cuda):
    x = torch.randn(100, 8, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        trg.row_rows(x, idx.float())
    with pytest.raises(ValueError, match="contiguous"):
        trg.row_rows(x.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="one CUDA device"):
        trg.row_rows(x, idx.cpu())
    with pytest.raises(TypeError, match="one type"):
        trg.sorted_block_rows(x, idx, idx[:1].long(), 4, 8)


def test_grouped_bf16_steps_on_the_card_match_cpu(cuda):
    """bench.py's grouped bfloat16 program in small: frame_group 2 over a
    split the group rounding moves (4 + 3 chunks become 3 + 3)."""
    ds = synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()
    cfg = Config(**dict(TRAIN_KW, batch_size=256, linkbatchsize=32, pad_deg=32,
                        pad_deg2=16, ell_tables=True, k_small=8, frame_group=2,
                        dtype="bfloat16", small_frac=0.5, small_frac_neg=0.375))

    def check(tr):
        assert tr._split == (3, 3) and tr.x.dtype == torch.bfloat16

    before = tm.membership_counts.launches
    losses = {dev: _epoch_losses(cfg, ds, dev, check) for dev in ("cpu", "cuda")}
    # 3 small groups and 5 big groups a step, two membership launches each
    steps = ds.split_edge["train"]["edge"].shape[0] // cfg.batch_size
    assert tm.membership_counts.launches - before == 2 * steps * 2 * 8
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("c,r", [(4096, 8), (512, 128)])
def test_membership_broadcast_block_matches_plain(cuda, c, r):
    """The incomplete family's blocked recursion lookups: each anchor's row
    (C, 1, K) against its R candidates' rows (C, R, K), through
    _rowwise_membership, which expands the anchor's row over R before the
    kernel (one launch at C*R rows); exact at unit weights."""
    rng = np.random.default_rng(2)
    k, n = 16, 5000
    q = torch.as_tensor(rng.integers(0, n, size=(c, 1, k)).astype(np.int32),
                        device=cuda)
    ids = torch.as_tensor(np.sort(rng.integers(0, n, size=(c, r, k)), axis=-1)
                          .astype(np.int32), device=cuda)
    w = torch.ones(c, r, k, device=cuda)
    before = tm.membership_counts.launches
    shapes_before = tm.membership_counts.shapes[(c * r, k, k)]
    got = tf._rowwise_membership(q, ids, w)
    torch.cuda.synchronize()
    assert tm.membership_counts.launches == before + 1
    assert tm.membership_counts.shapes[(c * r, k, k)] == shapes_before + 1
    want = tm.membership_counts_plain(q.expand(c, r, k).reshape(-1, k),
                                      ids.reshape(-1, k), w.reshape(-1, k))
    assert got.shape == (c, r, k)
    assert torch.equal(got.reshape(-1, k), want)


@pytest.mark.parametrize("pred", ["cn2", "cn3"])
def test_family_steps_on_the_card_match_cpu(cuda, pred):
    """Two epochs of the incomplete family on ELL tables (frozen windows,
    no sample stream read) with the dual-K split and the blocked recursion
    at rec_k 8, on the card against the CPU."""
    ds = synthetic_dataset("Cora", seed=0, scale=0.2).reorder_bfs()
    cfg = Config(**dict(TRAIN_KW, predictor=pred, ell_tables=True, pad_deg=16,
                        pad_deg2=16, k_small=4, rec_k=8, trndeg=16, tstdeg=16,
                        depth=1, learnpt=True))

    def check(tr):
        assert tr._use_ell and tr._split and (tr.adj2 is None) == (pred == "cn2")

    before = tm.membership_counts.launches
    losses = {dev: _epoch_losses(cfg, ds, dev, check) for dev in ("cpu", "cuda")}
    assert tm.membership_counts.launches > before
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def _segments(rng, nseg, hub, lead=0, tail=0):
    lens = rng.integers(1, 9, size=nseg) * (rng.random(nseg) > 0.33)
    if hub:
        lens[nseg // 2] = hub
    return lead + np.concatenate([[0], np.cumsum(lens)]).astype(np.int64), tail


@pytest.mark.parametrize("nseg,hub,h,idx_dtype,scaled,dtype,lead,tail", [
    (5000, 0, 1, None, False, torch.float32, 0, 0),
    (5000, 0, 64, torch.int64, True, torch.float32, 0, 0),
    (3000, 0, 256, torch.int32, True, torch.float32, 0, 0),
    (2000, 12000, 256, torch.int32, True, torch.float32, 0, 0),   # a hub row
    (2000, 12000, 1, torch.int64, True, torch.float32, 0, 0),
    (1000, 400000, 5, torch.int64, False, torch.float32, 0, 0),   # the sentinel lanes
    (900, 0, 16, torch.int64, True, torch.float32, 5, 11),        # entries outside
    (3000, 0, 64, torch.int32, True, torch.bfloat16, 0, 0),
    (2000, 12000, 256, None, False, torch.bfloat16, 0, 0),        # bfloat16 out
])
def test_segment_sum_kernel_matches_plain(cuda, nseg, hub, h, idx_dtype, scaled,
                                          dtype, lead, tail):
    """The kernel against its plain version in float64: within rtol 1e-5
    (1e-2 with bfloat16 rows) of the sum of the terms' magnitudes; two
    calls bit-identical; empty segments 0."""
    rng = np.random.default_rng(nseg + hub + h)
    off, tail = _segments(rng, nseg, hub, lead, tail)
    q = int(off[-1]) + tail
    n_src = 3000 if idx_dtype is not None else q
    src = torch.as_tensor(rng.standard_normal((n_src, h)), device=cuda).to(dtype)
    idx = (None if idx_dtype is None else
           torch.as_tensor(rng.integers(0, n_src, size=q), device=cuda).to(idx_dtype))
    scale = (torch.as_tensor(rng.standard_normal(q), device=cuda).float()
             if scaled else None)
    off_t = torch.as_tensor(off, device=cuda)
    before = tss.segment_sum_raw.launches
    got = tss.segment_sum_raw(src, off_t, idx, scale)
    again = tss.segment_sum_raw(src, off_t, idx, scale)
    torch.cuda.synchronize()
    assert tss.segment_sum_raw.launches == before + 2
    assert got.dtype == (torch.float32 if scaled else dtype)
    assert torch.equal(got, again)
    sc = None if scale is None else scale.double()
    want = tss.segment_sum_plain(src.double(), off_t, idx, sc)
    mag = tss.segment_sum_plain(src.double().abs(), off_t, idx,
                                None if sc is None else sc.abs())
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert bool(((got.double() - want).abs() <= rtol * mag).all())
    empty = torch.as_tensor(off[1:] == off[:-1], device=cuda)
    assert empty.any() and not got[empty].any()


def test_segment_sum_planes_and_one_dimensional(cuda):
    """Transposed (M, P) planes read through their strides equal the sums of
    a contiguous copy, and 1-D values those of an (N, 1) column, bit for
    bit (the order of the adds depends on the entries and the width H)."""
    rng = np.random.default_rng(2)
    off, _ = _segments(rng, 4000, 300000)
    q = int(off[-1])
    planes = torch.as_tensor(rng.standard_normal((3, q)), device=cuda).float()
    perm = torch.randperm(q, device=cuda)
    off_t = torch.as_tensor(off, device=cuda)
    got = tss.segment_sum_raw(planes.T, off_t, perm)
    assert torch.equal(got, tss.segment_sum_raw(planes.T.contiguous(), off_t, perm))
    one = tss.segment_sum_raw(planes[1], off_t, perm)
    assert torch.equal(one, tss.segment_sum_raw(planes[1][:, None], off_t, perm)[:, 0])
    mag = tss.segment_sum_raw(planes[1].abs(), off_t, perm)
    assert bool(((one - got[:, 1]).abs() <= 1e-5 * mag).all())


def test_segment_sum_flushes_subnormals(cuda):
    """Subnormal terms and sums flush to zero on the card, as index_add_'s
    atomics and XLA's sums do; normal ones are untouched."""
    vals = torch.tensor([3e-39, 4e-39, 1.0, -1.0, 2e-30, 3e-30], device=cuda)
    off = torch.tensor([0, 2, 4, 6], device=cuda)
    got = tss.segment_sum_raw(vals, off)
    assert torch.equal(got, tss.segment_sum_plain(vals, off))
    assert got[0] == 0 and got[1] == 0 and got[2] == vals[4] + vals[5]


def test_segment_sum_wrapper_rejects(cuda):
    src = torch.randn(10, 4, device=cuda)
    off = torch.tensor([0, 4, 10], device=cuda)
    with pytest.raises(TypeError):
        tss.segment_sum_raw(src.double(), off)
    with pytest.raises(ValueError, match="int64"):
        tss.segment_sum_raw(src, off.int())
    with pytest.raises(ValueError, match="one CUDA device"):
        tss.segment_sum_raw(src, off.cpu())
    with pytest.raises(ValueError, match="scale"):
        tss.segment_sum_raw(src, off, None, torch.ones(3, device=cuda))


def _held(src, off_t, idx=None, scale=None, ordered=True):
    """The kernel on these inputs: two calls bit-identical, within rtol 1e-5
    (1e-2 with bfloat16 rows) of the sum of the terms' magnitudes of its
    plain version in float64, and, where ``ordered``, bit for bit the
    sums of segment_sum_ordered (the kernel's order written out on the
    CPU)."""
    got = tss.segment_sum_raw(src, off_t, idx, scale)
    again = tss.segment_sum_raw(src, off_t, idx, scale)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    sc = None if scale is None else scale.double()
    want = tss.segment_sum_plain(src.double(), off_t, idx, sc)
    mag = tss.segment_sum_plain(src.double().abs(), off_t, idx,
                                None if sc is None else sc.abs())
    rtol = 1e-2 if src.dtype == torch.bfloat16 else 1e-5
    assert bool(((got.double() - want).abs() <= rtol * mag + 1e-30).all())
    if ordered:
        ref = tss.segment_sum_ordered(src.cpu(), off_t.cpu(),
                                      None if idx is None else idx.cpu(),
                                      None if scale is None else scale.cpu())
        assert torch.equal(_bits(got.cpu()), _bits(ref))
    return got


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("h", [1, 2, 3, 4, 5, 8, 31, 32, 33, 255, 256, 257])
def test_segment_sum_widths(cuda, h):
    """Both paths (narrow to H = 8, wide above; 16-byte rows where H allows
    it, else 4 bytes a lane) at every width: hubs that cross shares, runs of
    empty segments, entries before and after every segment; bit for bit the
    ordered sums."""
    rng = np.random.default_rng(100 + h)
    off, tail = _segments(rng, 1500, 3000, lead=3, tail=5)
    q = int(off[-1]) + tail
    src = torch.as_tensor(rng.standard_normal((700, h)), device=cuda).float()
    idx = torch.as_tensor(rng.integers(0, 700, size=q), device=cuda)
    scale = torch.as_tensor(rng.standard_normal(q), device=cuda).float()
    _held(src, torch.as_tensor(off, device=cuda), idx, scale)


@pytest.mark.parametrize("h", [3, 64, 256])
def test_segment_sum_strided_rows(cuda, h):
    """A misaligned view (x[:, 1:]) and an odd row stride take the scalar
    path; they equal the contiguous call (the vector path where H allows)
    bit for bit."""
    rng = np.random.default_rng(7 + h)
    off, _ = _segments(rng, 2000, 2500)
    off_t = torch.as_tensor(off, device=cuda)
    q = int(off[-1])
    base = torch.as_tensor(rng.standard_normal((500, h + 3)), device=cuda).float()
    idx = torch.as_tensor(rng.integers(0, 500, size=q), device=cuda).int()
    view = base[:, 1:h + 1]
    odd = torch.as_tensor(rng.standard_normal((500 * (h + 1),)), device=cuda).float()
    odd = odd.as_strided((500, h), (h + 1, 1))
    for x in (view, odd):
        got = _held(x, off_t, idx)
        assert torch.equal(got, tss.segment_sum_raw(x.contiguous(), off_t, idx))


@pytest.mark.parametrize("h", [256, 264])
def test_segment_sum_bf16_rows(cuda, h):
    """bfloat16 rows, 8 values in a 16-byte load (H = 264 = 33 vectors: one
    lane holds two)."""
    rng = np.random.default_rng(h)
    off, _ = _segments(rng, 1200, 2000)
    q = int(off[-1])
    src = torch.as_tensor(rng.standard_normal((900, h)), device=cuda).bfloat16()
    idx = torch.as_tensor(rng.integers(0, 900, size=q), device=cuda)
    scale = torch.as_tensor(rng.standard_normal(q), device=cuda).float()
    _held(src, torch.as_tensor(off, device=cuda), idx, scale)
    rows = torch.as_tensor(rng.standard_normal((q, h)), device=cuda).bfloat16()
    assert _held(rows, torch.as_tensor(off, device=cuda)).dtype == torch.bfloat16


@pytest.mark.parametrize("h", [3, 256])
def test_segment_sum_long_segment_and_trailing_empties(cuda, h):
    """A segment of 400,000 entries that many share cuts fall inside (the
    frames' sentinel lanes), then 100,000 empty segments at the end (the
    column sums' trailing ranks): the empties 0."""
    rng = np.random.default_rng(11)
    lens = np.concatenate([rng.integers(0, 5, size=3000), [400000],
                           rng.integers(0, 5, size=3000), np.zeros(100000, np.int64)])
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    q = int(off[-1])
    off_t = torch.as_tensor(off, device=cuda)
    src = torch.as_tensor(rng.standard_normal((2000, h)), device=cuda).float()
    idx = torch.as_tensor(rng.integers(0, 2000, size=q), device=cuda)
    got = _held(src, off_t, idx, ordered=h <= tss.NARROW_COLS)
    assert not got[-100000:].any()


@pytest.mark.parametrize("pred", ["cn5", "cn3"])
def test_one_seed_one_result_on_the_card(cuda, pred):
    """Two runs of two epochs from one seed on the card give the same
    losses and parameters, bit for bit: every scatter-add of the port is the
    segment sum's fixed order."""
    ds = synthetic_dataset("Cora", seed=0, scale=0.2).reorder_bfs()
    kw = dict(TRAIN_KW, gnndp=0.1, predp=0.1, preedp=0.1)
    if pred == "cn3":
        kw.update(predictor=pred, ell_tables=True, pad_deg=16, pad_deg2=16,
                  k_small=4, rec_k=8, trndeg=16, tstdeg=16, depth=1)
    cfg = Config(**kw)
    runs = []
    for _ in range(2):
        before = tss.segment_sum_raw.launches
        tr = Trainer(cfg, ds, device=cuda)
        state = tr.init_state(0)
        rng = np.random.default_rng(0)
        losses = [tr.train_epoch(state, rng, ep)[1] for ep in (1, 2)]
        assert tss.segment_sum_raw.launches > before
        runs.append((losses, [p.detach().clone() for p in
                              list(state.encoder.parameters())
                              + list(state.predictor.parameters())]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# the step program (train/step_graph.py): small versions of bench.py's
# grouped bfloat16 program on the ELL tables and the dual-K split, of the
# window table, and of cn3, dropout on
CAPTURE_KW = dict(TRAIN_KW, batch_size=256, linkbatchsize=32, pad_deg=32,
                  pad_deg2=16, ell_tables=True, k_small=8, gnndp=0.1, xdp=0.1,
                  tdp=0.1, gnnedp=0.1, predp=0.1, preedp=0.1)
CAPTURE_CASES = {
    "cn5_ell_dualk_groups": dict(frame_group=2, dtype="bfloat16",
                                 small_frac=0.5, small_frac_neg=0.375),
    "cn5_window": dict(window_table=True),
    "cn3": dict(predictor="cn3", pad_deg=16, k_small=4, rec_k=8, trndeg=16,
                tstdeg=16, depth=1, learnpt=True),
}


def _held_tensors(state):
    """Every parameter and buffer (the EMA among them) and Adam's state,
    copied off the card."""
    out = {f"enc.{k}": v for k, v in state.encoder.state_dict().items()}
    out.update({f"pred.{k}": v for k, v in state.predictor.state_dict().items()})
    for i, s in enumerate(state.opt.state.values()):
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def _program_steps(cfg, ds, dev, capture, nsteps=3):
    """``nsteps`` steps through train_step with a generator of the caller's,
    the ELL tables refreshed in place after the first; (losses, tensors,
    membership launches per step, the trainer)."""
    tr = Trainer(cfg, ds, device=dev, capture=capture)
    state = tr.init_state(0)
    tr._refresh_ell(np.random.default_rng(1))
    rng = np.random.default_rng(0)
    e = tr.train_edges.shape[1]
    perm = rng.permutation(e)
    neg = B.negative_sampling(ds.edge_index, ds.n_nodes, e, rng)
    bs = cfg.batch_size
    gen = torch.Generator(device=dev).manual_seed(0)
    losses, launches = [], []
    for i in range(nsteps):
        if i == 1:
            tr._refresh_ell(np.random.default_rng(2))
        idx = perm[i * bs:(i + 1) * bs]
        inputs = tr.prepare_batch(tr.train_edges[:, idx], neg[:, idx], idx)
        before = tm.membership_counts.launches
        state, loss = tr.train_step(state, *inputs[:3], gen, *inputs[3:])
        losses.append(loss)
        launches.append(tm.membership_counts.launches - before)
    torch.cuda.synchronize()
    return torch.stack(losses).cpu(), _held_tensors(state), launches, tr


@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_captured_steps_equal_eager_steps(cuda, case):
    """The captured step against the eager one, bit for bit over three
    steps (warm-up, capture and replay, replay): losses, parameters, Adam's
    moments and step counts, the EMA buffers; and the same membership
    launches a step, counted through the replays."""
    ds = synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()
    cfg = Config(**dict(CAPTURE_KW, **CAPTURE_CASES[case]))
    runs = {c: _program_steps(cfg, ds, cuda, c) for c in (False, True)}
    (l0, t0, m0, tr0), (l1, t1, m1, tr1) = runs[False], runs[True]
    assert not tr0._program.capture and tr0._program.replays == 0
    assert tr1._program.capture and tr1._program.replays == 2
    assert tr1._program.capture_s > 0
    assert torch.equal(l0, l1) and len(set(l0.tolist())) == 3
    assert m0 == m1 and min(m0) > 0
    assert t0.keys() == t1.keys()
    for k in t0:
        assert torch.equal(t0[k], t1[k]), k


def test_captured_epochs_equal_eager_epochs(cuda):
    """Two epochs through train_epoch: the trainer's generator, registered
    with the graph once, reseeded each epoch; the ELL tables rebuilt in
    place; the same mean losses bit for bit."""
    ds = synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()
    cfg = Config(**dict(CAPTURE_KW, **CAPTURE_CASES["cn5_ell_dualk_groups"]))
    out = []
    for capture in (False, True):
        tr = Trainer(cfg, ds, device=cuda, capture=capture)
        state = tr.init_state(0)
        rng = np.random.default_rng(0)
        out.append([tr.train_epoch(state, rng, ep)[1] for ep in (1, 2)])
    assert out[0] == out[1]


def test_the_profiler_sees_a_replayed_step(cuda):
    """torch.profiler's trace holds the kernels of a replayed graph, the
    port's segment-sum kernels among them."""
    ds = synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()
    cfg = Config(**dict(CAPTURE_KW, **CAPTURE_CASES["cn5_ell_dualk_groups"]))
    *_, tr = _program_steps(cfg, ds, cuda, True, nsteps=2)
    state = tr._program._held[0]
    inputs = tr.prepare_batch(tr.train_edges[:, :256], tr.train_edges[:, 256:512],
                              np.arange(256))
    gen = torch.Generator(device=cuda).manual_seed(1)
    replays = tr._program.replays
    _, out = profiling.profile_region(
        lambda: tr.train_step(state, *inputs[:3], gen, *inputs[3:])[1].item())
    assert tr._program.replays == replays + 1
    assert out["device_activities"] > 0 and out["device_busy_ms"] > 0
    assert out["kernel_classes"]["segment_sum"]["launches"] > 0


# the epoch's negatives (ops/negatives.py), on graphs of the kinds of
# tests/test_torch_negatives.py: a BFS-relabelled one of 50,004 nodes, and
# dense ones that take a second round, run short or accept nothing
def _dense_edges(n, removed):
    gone = {(u, u + 1) for u in range(removed)}
    return np.array([(u, v) for u in range(n) for v in range(n)
                     if u != v and (min(u, v), max(u, v)) not in gone], np.int64).T


NEG_GRAPHS = {
    "bfs50k": lambda: synthetic_dataset("collab", seed=2, scale=0.212).reorder_bfs(),
    "dense_two_rounds": lambda: types.SimpleNamespace(edge_index=_dense_edges(16, 15),
                                                      n_nodes=16),
    "dense_short": lambda: types.SimpleNamespace(edge_index=_dense_edges(16, 1),
                                                 n_nodes=16),
    "complete": lambda: types.SimpleNamespace(edge_index=_dense_edges(12, 0), n_nodes=12),
}
ALL_ROUNDS = -(-tneg.max_attempts(1000) // tneg.round_size(1000))


@pytest.mark.parametrize("graph,num,seed,rounds", [
    ("bfs50k", None, 0, 1),
    ("bfs50k", None, 3000000001, 1),
    ("bfs50k", None, 2**62 - 1, 1),
    ("bfs50k", 4097, 12345, 1),
    ("dense_two_rounds", 1000, 5, 2),
    ("dense_two_rounds", 1000, 0, 2),
    ("dense_short", 1000, 9, ALL_ROUNDS),
    ("complete", 1000, 3, ALL_ROUNDS),
])
def test_negatives_kernel_matches_the_host_sampler(cuda, graph, num, seed, rounds):
    """The kernel against the native host sampler (sorted keys) and the
    plain version, bit for bit, short returns included (each counted in
    ``negatives.short``); the rounds each graph needs, three launches each."""
    ds = NEG_GRAPHS[graph]()
    n = ds.n_nodes
    num = ds.edge_index.shape[1] if num is None else num
    keys = native.load().negative_sampling(B.edge_keys(ds.edge_index, n), n, num, seed)
    want = np.stack([keys // n, keys % n])
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    g = graph_from_numpy(ip, col, n)
    plain = tneg.negatives(g.indptr, g.col, n, num, seed)
    launches, before, short = (tneg.negatives.launches, tneg.negatives.rounds,
                               tneg.negatives.short)
    got = tneg.negatives(g.indptr.to(cuda), g.col.to(cuda), n, num, seed)
    assert tneg.negatives.launches - launches == rounds * tneg.KERNELS_A_ROUND
    assert tneg.negatives.rounds - before == rounds
    assert tneg.negatives.short - short == (want.shape[1] < num)
    assert got.is_cuda and got.dtype == torch.int64
    assert np.array_equal(got.cpu().numpy(), want)
    assert np.array_equal(plain.numpy(), want)
    if graph == "complete":
        assert want.shape[1] == 0
    elif graph == "dense_short":
        assert 0 < want.shape[1] < num
    else:
        assert want.shape[1] == num


def test_negatives_wrapper_rejects(cuda):
    g = graph_from_numpy(*B.csr_from_edge_index(_dense_edges(8, 2), 8), 8)
    ip, col = g.indptr.to(cuda), g.col.to(cuda)
    with pytest.raises(TypeError):
        tneg.negatives(ip.long(), col, 8, 10, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tneg.negatives(ip, torch.stack([col, col], 1)[:, 0], 8, 10, 0)
    with pytest.raises(ValueError, match="one CUDA device"):
        tneg.negatives(ip, col.cpu(), 8, 10, 0)


def test_a_short_card_draw_takes_the_host_rounds(cuda):
    """A card draw whose candidates run out goes on with the host
    sampler's NumPy rounds from the same stream (``Trainer._graph_negatives``
    over card tensors): the error (those rounds draw fewer candidates than
    the card tried, so here they run out too) and the stream after it are
    ``B.negative_sampling``'s, and ``negatives.short`` counts it; a draw
    that fills gives its links."""
    for graph, num, seed in (("dense_short", 1000, 2), ("complete", 30, 1),
                             ("dense_two_rounds", 1000, 4)):
        ds = NEG_GRAPHS[graph]()
        n = ds.n_nodes
        g = graph_from_numpy(*B.csr_from_edge_index(ds.edge_index, n), n)
        tr = types.SimpleNamespace(ds=ds, g=types.SimpleNamespace(
            indptr=g.indptr.to(cuda), col=g.col.to(cuda)))
        short = tneg.negatives.short
        outs = []
        for draw in (lambda r: Trainer._graph_negatives(tr, num, r),
                     lambda r: B.negative_sampling(ds.edge_index, n, num, r)):
            rng = np.random.default_rng(seed)
            try:
                outs.append((draw(rng), rng.integers(2**62)))
            except RuntimeError as e:
                outs.append((str(e), rng.integers(2**62)))
        assert tneg.negatives.short - short == (graph != "dense_two_rounds")
        assert isinstance(outs[1][0], str) == (graph != "dense_two_rounds")
        assert outs[0][1] == outs[1][1]
        if isinstance(outs[1][0], str):
            assert outs[0][0] == outs[1][0]
        else:
            assert np.array_equal(outs[0][0], outs[1][0])
            assert outs[0][0].shape == (2, num)


def _host(t):
    return None if t is None else t.cpu()


def test_card_epochs_draw_the_cpu_negatives(cuda):
    """Two epochs on the card draw their negatives with the kernel, one
    round an epoch, and feed the steps the CPU trainer's batches (drawn by
    the host sampler), generator seeds and stream, bit for bit."""
    ds = synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()
    cfg = Config(**dict(TRAIN_KW, batch_size=256, ell_tables=True, k_small=8))
    runs = []
    for dev in ("cpu", cuda):
        tr = Trainer(cfg, ds, device=dev)
        state = tr.init_state(0)
        calls = []

        def recording(state, pos, neg, mp, gen, inv_p=None, inv_n=None, _c=calls):
            _c.append((pos.cpu(), neg.cpu(), _host(inv_p), _host(inv_n), gen.initial_seed()))
            return state, torch.zeros((), device=pos.device)

        tr.train_step = recording
        rng = np.random.default_rng(7)
        rounds = tneg.negatives.rounds
        tr.train_epoch(state, rng, 1)
        tr.train_epoch(state, rng, 2)
        runs.append((calls, rng.integers(2**62), tneg.negatives.rounds - rounds))
    (c0, r0, l0), (c1, r1, l1) = runs
    assert (l0, l1) == (0, 2) and r0 == r1
    assert len(c0) == len(c1) >= 4
    for a, b in zip(c0, c1):
        assert all(torch.equal(x, y) for x, y in zip(a[:4], b[:4])) and a[4] == b[4]
        assert a[2] is not None

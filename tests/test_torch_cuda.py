"""The port on the card: the CUDA membership, window-gather, row-gather,
sorted-block-gather and segment-sum kernels against their plain versions,
and the kernels' callers on CUDA tensors against the same calls on CPU
tensors (the grouped bfloat16 steps among them), and two runs of one seed
on the card against each other, bit for bit.  Every test here is marked ``cuda``
and skips without a GPU.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from ocn_tpu_torch.config import Config
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.ops import membership as tm
from ocn_tpu_torch.ops import row_gather as trg
from ocn_tpu_torch.ops import segment_sum as tss
from ocn_tpu_torch.ops import window_gather as tw
from ocn_tpu_torch.scripts import bench_gather as G
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse.csr import graph_from_numpy
from ocn_tpu_torch.train.loop import Trainer
from ocn_tpu_torch.utils import profiling

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

"""The port on the card: the CUDA membership and window-gather kernels
against their plain versions, and the kernels' callers on CUDA tensors
against the same calls on CPU tensors.  Every test here is marked ``cuda``
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
from ocn_tpu_torch.ops import window_gather as tw
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse.csr import graph_from_numpy
from ocn_tpu_torch.train.loop import Trainer

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
    ((300,), 16, 32, 77, True),         # ragged rows, many duplicates
    ((64, 8), 64, 16, 500, True),       # (B, R, K) leading dims
    ((100,), 4, 1500, 50, False),       # Ks past one shared-memory tile
])
def test_membership_kernel_matches_plain(cuda, lead, kq, ks, n, unit_w):
    q, ids, w = (torch.as_tensor(a, device=cuda) for a in
                 _inputs(np.random.default_rng(0), lead, kq, ks, n, unit_w))
    before = tm.membership_counts.launches
    got = tm.membership_counts(q, ids, w)
    torch.cuda.synchronize()
    assert tm.membership_counts.launches == before + 1
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


@pytest.mark.parametrize("e,h,b,k,dtype", [
    (1_324_714, 256, 4096, 64, torch.float32),   # the train chunk, big body
    (1_324_714, 256, 4096, 16, torch.float32),   # the small body
    (1_324_714, 256, 65536, 64, torch.float32),  # the eval batch
    (5, 7, 6, 4, torch.float32),                 # E < J: every window clamps
    (1000, 33, 100, 16, torch.bfloat16),         # 2-byte units
    (300, 13, 50, 8, torch.uint8),               # byte units
])
def test_window_rows_kernel_matches_plain(cuda, e, h, b, k, dtype):
    gen = torch.Generator(device=cuda).manual_seed(e + k)
    y = torch.randn((e, h), generator=gen, device=cuda).to(dtype)
    pos0 = torch.randint(0, max(e - k, 0) + 1, (b,), generator=gen,
                         device=cuda, dtype=torch.int32)
    pos0[-1] = max(e - k, 0)
    before = tw.window_rows.launches
    rows, off = tw.window_rows(y, pos0, k)
    torch.cuda.synchronize()
    assert tw.window_rows.launches == before + 1
    want, want_off = tw.window_rows_plain(y, pos0, k)
    assert rows.shape == (b, k + tw.SLACK, h)
    assert torch.equal(rows, want) and torch.equal(off, want_off)  # a copy


def test_window_rows_unaligned_table(cuda):
    flat = torch.randn(2000 * 64 + 1, device=cuda)
    y = flat[1:].view(2000, 64)  # 4 bytes off 16-byte alignment
    pos0 = torch.randint(0, 2000 - 32, (300,), device=cuda)
    rows, off = tw.window_rows(y, pos0, 32)
    want, want_off = tw.window_rows_plain(y, pos0, 32)
    assert torch.equal(rows, want) and torch.equal(off, want_off)


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

"""The segment-sum kernel's order of adds written out (ops/segment_sum.py
segment_sum_ordered) against the plain version (float64) and the JAX
package's jax.ops.segment_sum: within rtol 1e-5 of the sum of the terms'
magnitudes, on hubs that cross shares, runs of empty segments, trailing
empties and entries before and after every segment, at H in {1, 3, 5, 16,
64, 256} (both paths of csrc/segment_sum.cu).  The card's tests hold the
kernel to segment_sum_ordered bit for bit (tests/test_torch_cuda.py,
chip_smoke.py's kernels phase); here the order's own properties: the
merge-path cuts, and a segment inside one share summed as index_add_ sums
it in index order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu_torch.ops import segment_sum as SS
from torch_parity import one_thread  # noqa: F401 (autouse: one intra-op thread)

RTOL = 1e-5


def _case(rng, nseg, h, hub=0, empties=0, lead=0, tail=0, n_src=400):
    """Ragged segments (a third empty, one of ``hub`` entries, ``empties``
    empty ones at the end), ``lead`` entries before the first and ``tail``
    after the last, int64 rows of an (n_src, h) table, scales."""
    lens = rng.integers(1, 9, size=nseg) * (rng.random(nseg) > 0.33)
    if hub:
        lens[nseg // 2] = hub
    lens = np.concatenate([lens, np.zeros(empties, np.int64)])
    off = lead + np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    q = int(off[-1]) + tail
    src = rng.standard_normal((n_src, h)).astype(np.float32)
    idx = rng.integers(0, n_src, size=q)
    scale = rng.standard_normal(q).astype(np.float32)
    return off, src, idx, scale


def _jax_sum(off, src, idx, scale):
    q = len(idx)
    seg = np.full(q, len(off) - 1)
    for s in range(len(off) - 1):
        seg[off[s]:off[s + 1]] = s
    rows = jnp.asarray(scale)[:, None] * jnp.asarray(src)[jnp.asarray(idx)]
    return np.asarray(jax.ops.segment_sum(rows, jnp.asarray(seg), num_segments=len(off) - 1,
                                          indices_are_sorted=True))


@pytest.mark.parametrize("h,nseg,hub,empties,lead,tail", [
    (1, 3000, 5000, 0, 0, 0),       # row sums: a hub over several narrow shares
    (3, 1500, 3000, 4000, 2, 9),    # column sums: trailing empty ranks
    (5, 800, 0, 0, 7, 3),           # entries outside every segment
    (16, 600, 900, 0, 0, 0),        # wide path, 4-byte columns of 16
    (64, 500, 1500, 300, 1, 1),
    (256, 300, 700, 0, 0, 4),       # the SpMM's and the frame dx's width
])
def test_ordered_matches_plain_and_jax(h, nseg, hub, empties, lead, tail):
    rng = np.random.default_rng(h + nseg)
    off, src, idx, scale = _case(rng, nseg, h, hub, empties, lead, tail)
    t = [torch.as_tensor(a) for a in (src, off, idx, scale)]
    got = SS.segment_sum_ordered(*t).double()
    mag = SS.segment_sum_plain(t[0].double().abs(), t[1], t[2], t[3].double().abs())
    want = SS.segment_sum_plain(t[0].double(), t[1], t[2], t[3].double())
    assert bool(((got - want).abs() <= RTOL * mag + 1e-30).all())
    jx = torch.tensor(_jax_sum(off, src, idx, scale), dtype=torch.float64)
    assert bool(((got - jx).abs() <= RTOL * mag + 1e-6).all())
    if empties:
        assert not got[-empties:].any()


@pytest.mark.parametrize("h", [1, 256])
def test_merge_cuts(h):
    """The cuts split the merged list of ends and entries into shares of at
    most share + snap items, in order; no segment of at most snap entries is
    cut; cut b lies within snap items before b * share."""
    rng = np.random.default_rng(3)
    off, _, _, _ = _case(rng, 4000, 1, hub=20000, empties=3000, lead=5)
    share, snap = SS.share_for(h)
    nseg, nq = len(off) - 1, int(off[-1] - off[0])
    nshares = SS.share_count(nseg, int(off[-1]), h)
    ci, cj = SS.merge_splits(off, share, snap, nshares)
    pos = ci + cj
    assert ci[0] == 0 and cj[0] == 0 and ci[-1] == nseg and cj[-1] == nq
    assert (np.diff(ci) >= 0).all() and (np.diff(cj) >= 0).all()
    assert (np.diff(pos) <= share + snap).all()
    d = np.minimum(np.arange(nshares + 1) * share, nseg + nq)
    assert ((d - pos >= 0) & (d - pos <= snap)).all()
    # a cut inside segment i: its ends before are i, its entries before
    # reach past segment i's first
    inside = (ci < nseg) & (cj > off[np.minimum(ci, nseg - 1)] - off[0])
    lens = np.diff(off)
    assert (lens[ci[inside]] > snap).all()
    # every end lies after its segment's entries: end i before entry j iff
    # off[i + 1] - off[0] <= j, so a cut's ends all end by its entries
    before = ci > 0
    assert (off[ci[before]] - off[0] <= cj[before]).all()


@pytest.mark.parametrize("h", [16, 256])
def test_wide_share_sums_in_index_order(h):
    """On the wide path a segment inside one share is summed from 0 in
    increasing q: the bits of the plain version's float32 index_add_ in
    index order."""
    rng = np.random.default_rng(h)
    off, src, idx, scale = _case(rng, 700, h)
    t = [torch.as_tensor(a) for a in (src, off, idx, scale)]
    assert torch.equal(SS.segment_sum_ordered(*t), SS.segment_sum_plain(*t))


def test_narrow_fixup_spreads_a_long_segment():
    """A segment over many narrow shares reaches the fix-up as one run of
    pieces (G = 256 groups at H = 1), and its sum stays within rtol of the
    float64 one; a second call gives the same bits."""
    rng = np.random.default_rng(5)
    off, src, idx, scale = _case(rng, 200, 1, hub=60000)
    t = [torch.as_tensor(a) for a in (src, off, idx, scale)]
    share, snap = SS.share_for(1)
    ci, _ = SS.merge_splits(off, share, snap, SS.share_count(len(off) - 1, len(idx), 1))
    assert int((ci == 100).sum()) > 50  # cuts inside the hub, segment 100
    got = SS.segment_sum_ordered(*t)
    assert torch.equal(got, SS.segment_sum_ordered(*t))
    want = SS.segment_sum_plain(t[0].double(), t[1], t[2], t[3].double())
    mag = SS.segment_sum_plain(t[0].double().abs(), t[1], t[2], t[3].double().abs())
    assert bool(((got.double() - want).abs() <= RTOL * mag).all())


def test_ordered_flushes_and_takes_one_dimensional_rows():
    """Subnormal terms and sums flush to zero, as the kernel's ftz adds do;
    1-D values and bfloat16 rows give the plain version's dtype and shape."""
    vals = torch.tensor([3e-39, 4e-39, 1.0, -1.0, 2e-30, 3e-30])
    off = torch.tensor([0, 2, 4, 6])
    got = SS.segment_sum_ordered(vals, off)
    assert got.shape == (3,) and torch.equal(got, SS.segment_sum_plain(vals, off))
    bf = torch.randn(50, 8).bfloat16()
    boff = torch.tensor([0, 10, 10, 50])
    out = SS.segment_sum_ordered(bf, boff)
    assert out.dtype == torch.bfloat16 and out.shape == (3, 8)
    torch.testing.assert_close(out, SS.segment_sum_plain(bf, boff), rtol=1e-2, atol=1e-2)

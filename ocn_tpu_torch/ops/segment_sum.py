"""Sorted segment sums in a fixed order: the CUDA kernel and its plain version.

    out[s] = sum_{q in [off[s], off[s+1])} scale[q] * src[idx[q]]

The counterpart of the JAX package's ``jax.ops.segment_sum(...,
indices_are_sorted=True)`` (XLA's, not a Pallas kernel): the encoder's SpMM
and its backward (ops/spmm.py), the frames' column sums and the frame-matmul
dx (ops/frame.py), the incomplete family's column sums
(nn/predictors/cn_incomplete.py), the graph's row sums (sparse/csr.py) and
the multi-device tier's (parallel/).  On the card PyTorch's ``index_add_``
sums with atomics, in an order that changes from run to run, so one seed
gave other numbers in every run; the kernel's order of adds is fixed by the
entries alone (csrc/segment_sum.cu), so one input gives one result, as in
the JAX package, with no global switch.

On CUDA tensors the wrapper launches ``csrc/segment_sum.cu`` (built with
nvcc for sm_90a on first use, bound with ctypes); on CPU tensors it runs
``segment_sum_plain``, float32 ``index_add_`` in index order, which sums
each segment in increasing q as the kernel does inside one share (on rows
wider than 8, or up to 4 entries of one thread on narrower rows).  A CUDA
call launches the kernel or raises: there is no fallback.
``segment_sum_ordered`` repeats the kernel's own order of adds in plain
PyTorch, for tests on small inputs only.
``segment_sum_raw.launches`` counts kernel launches.  ``active()`` is true
while the wrapper runs, so that a dispatch mode can tell its own
scatter-adds (the plain version's) from any other.

``segment_sum`` and ``segment_sum_by`` (unsorted keys, through a stable
argsort) are differentiable; their backwards are gathers and further
segment sums, never a scatter-add.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ocn_tpu_torch.utils import toolchain

# source and the operation it stands for, for reports (chip_smoke.py): XLA's
# sorted segment sum in the JAX package's SpMM, not a Pallas kernel
SOURCE = "ocn_tpu_torch/csrc/segment_sum.cu"
REPLACES = "ocn_tpu/ops/spmm.py:49"

_LIB = None
_DEPTH = 0


def build() -> str:
    """Build (or find) the kernel library; returns its path."""
    return toolchain.build_cuda("segment_sum")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.ocn_segment_sum.argtypes = [
            p, i, i64, i64, p, i, p, p, i64, i64, i64, i64, i64, p, p, p]
        lib.ocn_segment_sum.restype = ctypes.c_int
        lib.ocn_segment_sum_scratch.argtypes = [i64, i64]
        lib.ocn_segment_sum_scratch.restype = i64
        _LIB = lib
    return _LIB


def active() -> bool:
    """True while a segment sum runs (read by dispatch-mode guards)."""
    return _DEPTH > 0


@contextlib.contextmanager
def _inside():
    global _DEPTH
    _DEPTH += 1
    try:
        yield
    finally:
        _DEPTH -= 1


# the kernel's shares (csrc/segment_sum.cu): rows of at most NARROW_COLS
# columns take the narrow path (a block of 256 threads a share, 4 entries a
# thread, up to 1,024 items), wider rows the wide path (a warp a share, up
# to 192 items); (items a share, entries a cut may move back)
NARROW_COLS = 8
NARROW_SHARE = (768, 256)
WIDE_SHARE = (128, 64)
NARROW_THREADS, NARROW_PER = 256, 4
WIDE_FIX_GROUPS = 16


def share_for(h: int) -> Tuple[int, int]:
    """(share, snap) of the kernel's merge-path shares at width h."""
    return NARROW_SHARE if h <= NARROW_COLS else WIDE_SHARE


def share_count(nseg: int, q: int, h: int) -> int:
    """Shares the wrapper allots for nseg segments over q entries: enough
    for any offsets (off[S] - off[0] <= q); the kernel leaves the rest
    empty."""
    return max(-(-(nseg + q) // share_for(h)[0]), 1)


def out_dtype(src: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.dtype:
    return src.dtype if scale is None else torch.promote_types(src.dtype, scale.dtype)


def entry_segments(off: torch.Tensor, q: int) -> torch.Tensor:
    """(q,) the segment of each entry; entries outside [off[0], off[S]) get
    S."""
    s = off.numel() - 1
    pos = torch.arange(q, dtype=off.dtype, device=off.device)
    seg = torch.searchsorted(off, pos, right=True) - 1
    return seg.masked_fill_(seg < 0, s)


def sorted_offsets(keys: torch.Tensor, nseg: int) -> torch.Tensor:
    """(nseg + 1,) int64 offsets of the runs of nondecreasing ``keys`` in
    [0, nseg): off[s] = the first position with keys >= s."""
    keys = keys.long()
    return torch.searchsorted(
        keys, torch.arange(nseg + 1, dtype=torch.int64, device=keys.device))


def sort_segments(keys: torch.Tensor, nseg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, off): the stable argsort of ``keys`` (values in [0, nseg)) and
    the offsets of its runs, so that segment s is keys == s."""
    keys = keys.reshape(-1).long()
    perm = torch.argsort(keys, stable=True)
    return perm, sorted_offsets(keys[perm], nseg)


def _flush(t: torch.Tensor) -> torch.Tensor:
    """Subnormal values to zero (the kernel's and XLA's float arithmetic)."""
    return t.masked_fill(t.abs() < torch.finfo(t.dtype).tiny, 0.0)


def segment_sum_plain(src: torch.Tensor, off: torch.Tensor,
                      idx: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same sums by ``index_add_`` in index order, accumulated in
    float32 (float64 for float64 inputs) and cast to the output type;
    subnormal terms and sums flush to zero, as in the kernel."""
    flat = src.dim() == 1
    s2 = src[:, None] if flat else src
    nseg = off.numel() - 1
    q = idx.numel() if idx is not None else s2.shape[0]
    want = out_dtype(src, scale)
    acc = torch.float64 if want == torch.float64 else torch.float32
    rows = (s2 if idx is None else s2[idx.long()]).to(acc)
    if scale is not None:
        rows = scale.to(acc)[:, None] * rows
    seg = entry_segments(off.long(), q)
    out = torch.zeros(nseg + 1, s2.shape[1], dtype=acc, device=src.device)
    out.index_add_(0, seg, _flush(rows))
    out = _flush(out[:nseg]).to(want)
    return out[:, 0] if flat else out


def merge_splits(off: np.ndarray, share: int, snap: int, nshares: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's cuts (seg_partition) of the merged list of segment ends
    and entries: for cuts 0..nshares, the ends and the entries (counted from
    off[0]) before each.  Cut b falls after b * share items, then moves back
    to its segment's first entry when 1..snap of its entries lie before it."""
    off = np.asarray(off, dtype=np.int64)
    nseg, nq = len(off) - 1, int(off[-1] - off[0])
    d = np.minimum(np.arange(nshares + 1, dtype=np.int64) * share, nseg + nq)
    # end i precedes entry j when off[i + 1] - off[0] <= j, so the ends among
    # the first d items are those with off[i + 1] - off[0] + i + 1 <= d
    key = off[1:] - off[0] + np.arange(1, nseg + 1)
    i = np.searchsorted(key, d, side="right")
    j = d - i
    inside = j - (off[np.minimum(i, nseg - 1)] - off[0])
    back = (i < nseg) & (inside > 0) & (inside <= snap)
    return i, np.where(back, j - inside, j)


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Subnormal values to zeros of their sign, as add.rn.ftz/mul.rn.ftz
    flush their inputs and results."""
    return torch.where(t.abs() < torch.finfo(t.dtype).tiny, t * 0.0, t)


def _fold(terms: torch.Tensor, h: int) -> torch.Tensor:
    """The terms' sum from 0 in increasing q (one column a lane, wide path)."""
    acc = torch.zeros(h)
    for row in terms:
        acc = _ftz(acc + row)
    return acc


def _narrow_share(terms: torch.Tensor, ends: np.ndarray) -> torch.Tensor:
    """Each entry's final running sum in one narrow share (seg_narrow):
    ``terms`` (nj, H) in q order, ``ends`` the share's segment ends (and the
    first one's start) counted from its first entry."""
    nj, h = terms.shape
    nt, per = NARROW_THREADS, NARROW_PER
    x = torch.zeros(nt * per, h)
    x[:nj] = terms
    head = torch.zeros(nt * per, dtype=torch.bool)
    head[0] = True
    p = ends[1:]
    head[torch.as_tensor(p[(p > 0) & (p < nj)], dtype=torch.int64)] = True
    e = torch.arange(nt)[:, None] * per + torch.arange(per)
    valid = e < nj
    # each thread's entries, from 0 at its first entry and at every head
    acc = torch.zeros(nt, h)
    first_head = torch.full((nt,), per)
    run = torch.zeros(nt, per, h)
    for r in range(per):
        hd = head[e[:, r]] & valid[:, r]
        first_head = torch.where(hd & (first_head == per), r, first_head)
        base = acc if r > 0 else torch.zeros(nt, h)
        new = _ftz(torch.where(hd[:, None], 0.0, base) + x[e[:, r]])
        acc = torch.where(valid[:, r, None], new, acc)
        run[:, r] = acc
    # the threads' sums: Hillis-Steele over the lanes, segmented at the
    # threads that hold a head, then in order over the warps
    lane, warp = torch.arange(nt) % 32, torch.arange(nt) // 32
    hw = (first_head < per).view(-1, 32)
    below = (torch.cumsum(hw.int(), 1) > 0).view(-1)
    start = torch.cummax(torch.where(hw, torch.arange(32), 0), 1).values.view(-1)
    for d in (1, 2, 4, 8, 16):
        y = torch.zeros_like(acc).view(-1, 32, h)
        y[:, d:] = acc.view(-1, 32, h)[:, :-d]
        acc = torch.where(((lane - d) >= start)[:, None], _ftz(y.view(-1, h) + acc), acc)
    wtot = acc.view(-1, 32, h)[:, 31]
    cin = torch.zeros(nt // 32, h)
    c = wtot[0]
    cin[1] = c
    for ww in range(2, nt // 32):
        c = wtot[ww - 1] if hw[ww - 1].any() else _ftz(c + wtot[ww - 1])
        cin[ww] = c
    acc = torch.where(((warp > 0) & ~below)[:, None], _ftz(cin[warp] + acc), acc)
    before = torch.cat([torch.zeros(1, h), acc[:-1]])
    before[lane == 0] = cin[warp[lane == 0]]
    later = torch.arange(nt) > 0
    vals = torch.stack([torch.where((later & (r < first_head))[:, None],
                                    _ftz(before + run[:, r]), run[:, r])
                        for r in range(per)], 1)
    return vals.reshape(nt * per, h)[:nj]


def segment_sum_ordered(src: torch.Tensor, off: torch.Tensor,
                        idx: Optional[torch.Tensor] = None,
                        scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """segment_sum_raw's sums with the kernel's own order of adds, in plain
    PyTorch on the CPU, for tests on small inputs (a Python loop over the
    shares and the wide path's entries); never on the main path.

    The order (csrc/segment_sum.cu): merge-path shares (merge_splits); on
    rows wider than NARROW_COLS each column of a share's piece of a segment
    summed from 0 in increasing q; on narrower rows 4 entries a thread from
    0, the threads' sums in a segmented Hillis-Steele scan over the lanes
    and in order over the warps (_narrow_share); a segment that crosses
    shares gets its pieces in share order, group g of G adding pieces g,
    g + G, ... and the groups meeting in a binary tree.  Products and sums
    flush subnormals to zero (_ftz).  The result equals the kernel's bit
    for bit."""
    flat = src.dim() == 1
    s2 = src[:, None] if flat else src
    nseg, h = off.numel() - 1, s2.shape[1]
    q = idx.numel() if idx is not None else s2.shape[0]
    want = out_dtype(src, scale)
    if nseg == 0:
        return torch.zeros(src.shape[:0] if flat else (0, h), dtype=want, device=src.device)
    offs = off.cpu().numpy().astype(np.int64)
    rows = _ftz((s2 if idx is None else s2[idx.long()]).float().cpu())
    terms = rows if scale is None else _ftz(_ftz(scale.float().cpu())[:, None] * rows)
    share, snap = share_for(h)
    nshares = share_count(nseg, q, h)
    cut_i, cut_j = merge_splits(offs, share, snap, nshares)
    narrow = h <= NARROW_COLS
    out = torch.zeros(nseg, h)
    carry = torch.zeros(nshares, h)
    carry_seg = np.full(nshares, -1)
    for b in range(nshares):
        i0, i1 = int(cut_i[b]), int(cut_i[b + 1])
        q0, nj = int(offs[0] + cut_j[b]), int(cut_j[b + 1] - cut_j[b])
        if narrow and nj:
            vals = _narrow_share(terms[q0:q0 + nj], offs[i0:i1 + 1] - q0)
        for k in range(i0, i1):
            st, e = int(offs[k]), int(offs[k + 1])
            if st == e or e <= q0:
                continue
            out[k] = vals[e - 1 - q0] if narrow else _fold(terms[max(st, q0):e], h)
        if nj and i1 < nseg and offs[i1] < q0 + nj:
            carry[b] = vals[nj - 1] if narrow else _fold(
                terms[max(int(offs[i1]), q0):q0 + nj], h)
            carry_seg[b] = i1
    groups = NARROW_THREADS // (1 << (h - 1).bit_length()) if narrow else WIDE_FIX_GROUPS
    for b in range(nshares):
        s = int(carry_seg[b])
        if s < 0 or (b > 0 and carry_seg[b - 1] == s):
            continue
        m = int(np.searchsorted(cut_i, s, side="right")) - 1 - b
        pieces: List[torch.Tensor] = [carry[b + k] for k in range(m)] + [out[s]]
        ng = min(groups, m + 1)
        red = []
        for g in range(ng):
            acc = pieces[g]
            for k in range(g + groups, m + 1, groups):
                acc = _ftz(acc + pieces[k])
            red.append(acc)
        half = 1 << max(ng - 1, 0).bit_length() >> 1
        while half:
            for g in range(min(half, ng - half)):
                red[g] = _ftz(red[g] + red[g + half])
            half //= 2
        out[s] = red[0]
    out = out.to(device=src.device, dtype=want)
    return out[:, 0] if flat else out


def _launch(src, off, idx, scale) -> torch.Tensor:
    dev = src.device
    tensors = [t for t in (src, off, idx, scale) if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"segment_sum: tensors on {[str(t.device) for t in tensors]}; "
                         "all must be on one CUDA device (or the CPU)")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum takes float32 or bfloat16 src, got {src.dtype}")
    if off.dtype != torch.int64 or off.dim() != 1 or not off.is_contiguous():
        raise ValueError("segment_sum needs contiguous 1-D int64 offsets")
    if src.dim() not in (1, 2):
        raise ValueError(f"segment_sum takes 1-D or 2-D src, got {tuple(src.shape)}")
    s2 = src[:, None] if src.dim() == 1 else src
    q = s2.shape[0]
    if idx is not None:
        if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
            raise TypeError(f"segment_sum takes 1-D int32/int64 idx, got {idx.dtype}")
        idx = idx.contiguous()
        q = idx.numel()
    if scale is not None:
        if scale.shape != (q,):
            raise ValueError(f"segment_sum: scale {tuple(scale.shape)} for {q} entries")
        scale = scale.float().contiguous()
    nseg, h = off.numel() - 1, s2.shape[1]
    out = torch.empty(nseg, h, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    share, snap = share_for(h)
    nshares = share_count(nseg, q, h)
    lib = _lib()
    # the cuts, each share's carried segment and row, in one allocation
    scratch = torch.empty(lib.ocn_segment_sum_scratch(nshares, h), dtype=torch.int64,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ocn_segment_sum(
        s2.data_ptr(), int(s2.dtype == torch.bfloat16), s2.stride(0), s2.stride(1),
        0 if idx is None else idx.data_ptr(), 0 if idx is None else idx.element_size(),
        0 if scale is None else scale.data_ptr(), off.data_ptr(), nseg, h, share, snap,
        nshares, out.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err}")
    segment_sum_raw.launches += 1
    return out


def segment_sum_raw(src: torch.Tensor, off: torch.Tensor,
                    idx: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sums without autograd: (S,) for 1-D ``src``, else (S, H), in
    ``out_dtype``.  ``src`` (N,) or (N, H) float32/bfloat16 with any
    strides; ``off`` (S + 1,) nondecreasing int64, off[S] <= Q; ``idx`` (Q,)
    int32/int64 rows of src (None: row q); ``scale`` (Q,) float32 (None: 1).
    Q is idx's length, or N without idx."""
    with _inside():
        if src.device.type == "cpu":
            return segment_sum_plain(src, off, idx, scale)
        out = _launch(src, off, idx, scale)
        want = out_dtype(src, scale)
        out = out if want == torch.float32 else out.to(want)
        return out[:, 0] if src.dim() == 1 else out


segment_sum_raw.launches = 0


class _SegmentSum(torch.autograd.Function):
    """segment_sum_raw with its VJP: d src = the cotangent of each entry's
    segment, times its scale, summed into its row (a keyed segment sum over
    ``idx``); d scale[q] = <src[idx[q]], dout[seg(q)]>."""

    @staticmethod
    def forward(ctx, src, off, idx, scale):
        ctx.save_for_backward(src, off, idx, scale)
        return segment_sum_raw(src, off, idx, scale)

    @staticmethod
    def backward(ctx, dout):
        src, off, idx, scale = ctx.saved_tensors
        flat = src.dim() == 1
        d2 = dout[:, None] if flat else dout
        q = idx.numel() if idx is not None else src.shape[0]
        seg = entry_segments(off, q)
        # row S is the cotangent of entries outside every segment
        g = torch.cat([d2, d2.new_zeros(1, d2.shape[1])])[seg]
        dsrc = dscale = None
        if ctx.needs_input_grad[0]:
            gs = g if scale is None else scale[:, None].to(g.dtype) * g
            if idx is not None:
                gs = segment_sum_by(gs, idx, src.shape[0])
            dsrc = (gs[:, 0] if flat else gs).to(src.dtype)
        if ctx.needs_input_grad[3]:
            s2 = src[:, None] if flat else src
            rows = s2 if idx is None else s2[idx.long()]
            dscale = (rows * g).sum(-1).to(scale.dtype)
        return dsrc, None, None, dscale


def segment_sum(src: torch.Tensor, off: torch.Tensor,
                idx: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[s] = sum over q in [off[s], off[s+1]) of scale[q] * src[idx[q]]
    (segment_sum_raw), differentiable in src and scale."""
    return _SegmentSum.apply(src, off, idx, scale)


class _KeyedSum(torch.autograd.Function):
    """Sum of src's rows by key; the VJP gathers the cotangent at the keys."""

    @staticmethod
    def forward(ctx, src, keys, perm, off):
        ctx.save_for_backward(keys)
        return segment_sum_raw(src, off, perm)

    @staticmethod
    def backward(ctx, dout):
        (keys,) = ctx.saved_tensors
        return dout[keys.reshape(-1).long()], None, None, None


def segment_sum_by(src: torch.Tensor, keys: torch.Tensor, nseg: int,
                   order: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """out[s] = sum of src[e] over the entries e with keys[e] == s, keys in
    [0, nseg), in the order of a stable argsort of the keys (the entries'
    own order within a segment).  ``order``: sort_segments(keys, nseg)
    when the caller already has it."""
    perm, off = order if order is not None else sort_segments(keys, nseg)
    return _KeyedSum.apply(src, keys, perm, off)

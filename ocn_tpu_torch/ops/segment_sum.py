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
each segment in increasing q as the kernel does inside a tile.  A CUDA call
launches the kernel or raises: there is no fallback.
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
from typing import Optional, Tuple

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
            p, i, i64, i64, p, i, p, p, i64, i64, i64, i64, p, p, p, p, p]
        lib.ocn_segment_sum.restype = ctypes.c_int
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


def tile_for(h: int) -> int:
    """Entries a tile of the kernel covers: short tiles for narrow rows keep
    enough threads busy (a thread walks a tile for one column)."""
    return 32 if h <= 8 else (64 if h <= 32 else 128)


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
    tile = tile_for(h)
    ntiles = max(-(-q // tile), 1)
    head = torch.empty(ntiles, h, dtype=torch.float32, device=dev)
    tail = torch.empty_like(head)
    tail_seg = torch.empty(ntiles, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().ocn_segment_sum(
        s2.data_ptr(), int(s2.dtype == torch.bfloat16), s2.stride(0), s2.stride(1),
        0 if idx is None else idx.data_ptr(), 0 if idx is None else idx.element_size(),
        0 if scale is None else scale.data_ptr(), off.data_ptr(), nseg, q, h, tile,
        out.data_ptr(), head.data_ptr(), tail.data_ptr(), tail_seg.data_ptr(), stream)
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

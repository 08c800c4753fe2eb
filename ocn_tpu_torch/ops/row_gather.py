"""Row gathers of a (N, H) table: the CUDA kernels and their plain versions.

Ports of the two row-gather Pallas kernels of the TPU instrument
scripts/bench_gather.py (ocn_tpu_torch/scripts/bench_gather.py is the port
of the instrument itself):

* ``row_rows``: out[m] = x[idx[m]], the counterpart of ``gather_p`` (one
  DMA per row) and of XLA's ``x[idx]``.  Ids are clamped into [0, N), as
  XLA clamps an out-of-range gather index; jnp's indexing would first wrap
  a negative id (-1 is the last row), which is not done here.
* ``sorted_block_rows``: the function of ``mk_blk -> kern2``.  Each tile of
  ``ts`` sorted ids owns a block of ``w`` rows of x from its base;
  out[m] = x[ids[m]] when base[m // ts] <= ids[m] < base[m // ts] + w (and
  ids[m] names a row of x), else zeros, which is what the TPU kernel's
  one-hot matmul gives.  The kernel reads the rows directly instead of
  multiplying (csrc/row_gather.cu says why).

On CUDA tensors both launch ``csrc/row_gather.cu`` (built with nvcc for
sm_90a on first use, bound with ctypes); on CPU tensors they run their
plain versions.  A CUDA call launches the kernel or raises: there is no
fallback.  ``row_rows.launches`` and ``sorted_block_rows.launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ocn_tpu_torch.utils import toolchain

# source and the TPU kernels replaced, for reports (chip_smoke.py)
SOURCE = "ocn_tpu_torch/csrc/row_gather.cu"
REPLACES = "scripts/bench_gather.py:86"
REPLACES_SORTED = "scripts/bench_gather.py:203"

_LIB = None


def build() -> str:
    """Build (or find) the kernel library; returns its path."""
    return toolchain.build_cuda("row_gather")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.ocn_row_rows.argtypes = [p, p, ctypes.c_int, p, i64, i64, i64, p]
        lib.ocn_row_rows.restype = ctypes.c_int
        lib.ocn_sorted_block_rows.argtypes = [
            p, p, p, ctypes.c_int, p, i64, i64, i64, i64, i64, p]
        lib.ocn_sorted_block_rows.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _on_cpu(name: str, x: torch.Tensor, *index: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version runs); for CUDA tensors,
    checks what the kernel takes and raises on anything else."""
    devs = {t.device.type for t in (x,) + index}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in (x,) + index}) != 1:
        raise ValueError(
            f"{name}: tensors on {[str(t.device) for t in (x,) + index]}; all "
            "must be on one CUDA device (or the CPU)")
    if x.dim() != 2 or any(t.dim() != 1 for t in index):
        raise ValueError(f"{name} shapes: x {tuple(x.shape)}, ids "
                         f"{[tuple(t.shape) for t in index]}; want (N, H), (M,)")
    if index[0].dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} takes int32 or int64 ids, got {index[0].dtype}")
    if not all(t.is_contiguous() for t in (x,) + index):
        raise ValueError(f"{name} needs contiguous tensors")
    if x.shape[0] == 0:
        raise ValueError(f"{name}: empty table")
    return False


def row_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[clamp(idx, 0, N - 1)]."""
    return x[idx.long().clamp(0, x.shape[0] - 1)]


def row_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, H) rows x[idx[m]] of a contiguous (N, H) table of any type, ids
    (M,) int32 or int64 clamped into [0, N)."""
    if _on_cpu("row_rows", x, idx):
        return row_rows_plain(x, idx)
    n, h = x.shape
    out = torch.empty((idx.shape[0], h), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().ocn_row_rows(
        x.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        out.data_ptr(), n, h * x.element_size(), idx.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"row gather kernel launch failed: CUDA error {err}")
    row_rows.launches += 1
    return out


row_rows.launches = 0


def sorted_block_rows_plain(x: torch.Tensor, ids: torch.Tensor,
                            bases: torch.Tensor, ts: int, w: int) -> torch.Tensor:
    """x[ids[m]] where ids[m] lies in its tile's block [base, base + w) of x,
    zeros elsewhere."""
    n = x.shape[0]
    idl = ids.long()
    base = bases.long().repeat_interleave(ts)[: idl.shape[0]]
    inside = (idl >= base) & (idl < base + w) & (idl >= 0) & (idl < n)
    rows = x[idl.clamp(0, n - 1)]
    return torch.where(inside[:, None], rows, torch.zeros((), dtype=x.dtype))


def sorted_block_rows(x: torch.Tensor, ids: torch.Tensor, bases: torch.Tensor,
                      ts: int, w: int) -> torch.Tensor:
    """(M, H) rows of a contiguous (N, H) table picked per tile of ``ts``
    ids from the tile's block of ``w`` rows at ``bases[t]`` (zeros for an
    id outside it).  ids (M,) and bases (ceil(M / ts),) int32 or int64, of
    one type; the ids are sorted in the instrument, but the result does not
    depend on it."""
    if ts <= 0 or w <= 0:
        raise ValueError(f"sorted_block_rows: ts={ts}, w={w}; both must be > 0")
    if bases.shape[0] != -(-ids.shape[0] // ts):
        raise ValueError(f"sorted_block_rows: {bases.shape[0]} bases for "
                         f"{ids.shape[0]} ids in tiles of {ts}")
    if _on_cpu("sorted_block_rows", x, ids, bases):
        return sorted_block_rows_plain(x, ids, bases, ts, w)
    if bases.dtype != ids.dtype:
        raise TypeError(f"sorted_block_rows: ids {ids.dtype}, bases "
                        f"{bases.dtype}; want one type")
    n, h = x.shape
    out = torch.empty((ids.shape[0], h), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().ocn_sorted_block_rows(
        x.data_ptr(), ids.data_ptr(), bases.data_ptr(),
        int(ids.dtype == torch.int64), out.data_ptr(), n, h * x.element_size(),
        ids.shape[0], ts, w, stream)
    if err != 0:
        raise RuntimeError(
            f"sorted block gather kernel launch failed: CUDA error {err}")
    sorted_block_rows.launches += 1
    return out


sorted_block_rows.launches = 0

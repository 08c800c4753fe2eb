"""Window gather: B contiguous (J, H) row windows of a table, the CUDA
kernel and its plain version.

Port of the Pallas TPU kernel ocn_tpu/ops/pallas/window_gather.py
(``window_rows`` -> ``_build``).  The candidate frame of a link chunk reads
feature rows at contiguous CSR window positions of the hoisted table
y = h.detach()[g.col] (ops/frame.py ``_FrameMatmulMultiWindow``): window b
is the J = K + SLACK rows starting at an 8-aligned position p0a[b] at or
below its true start pos0[b], and ``off = pos0 - p0a`` in [0, SLACK] tells
the caller where the K real rows begin.  The caller shifts its value planes
by ``off`` (``pad_vals``) instead of shifting the feature rows.

The 8-row alignment comes from the TPU compiler, not from the GPU; it is
kept so that rows and offsets equal the JAX function's element for element.

On CUDA tensors ``window_rows`` launches ``csrc/window_gather.cu`` (built
with nvcc for sm_90a on first use, bound with ctypes); on CPU tensors it runs
``window_rows_plain``.  A CUDA call is exactly one device kernel, which also
computes the aligned starts and writes the offsets; it launches or raises:
there is no fallback.  ``window_rows.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ocn_tpu_torch.utils import toolchain

# source and the TPU kernel it replaces, for reports (chip_smoke.py)
SOURCE = "ocn_tpu_torch/csrc/window_gather.cu"
REPLACES = "ocn_tpu/ops/pallas/window_gather.py:100"

SLACK = 8

_LIB = None


def build() -> str:
    """Build (or find) the kernel library; returns its path."""
    return toolchain.build_cuda("window_gather")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.ocn_window_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.ocn_window_rows.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def aligned_starts(pos0: torch.Tensor, e: int, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(aligned start, offset) per window; off in [0, SLACK]."""
    j = k + SLACK
    p0 = torch.clamp(torch.div(pos0, 8, rounding_mode="floor") * 8,
                     max=max(e - j, 0)).int()
    return p0, (pos0 - p0).int()


def window_rows_plain(y: torch.Tensor, pos0: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows[b, j] = y[min(p0a[b] + j, E - 1)] as one row gather (the XLA
    branch of the JAX function, window_gather.py:115-117)."""
    e = y.shape[0]
    p0a, off = aligned_starts(pos0, e, k)
    lane = torch.arange(k + SLACK, dtype=torch.int64, device=y.device)
    pos = torch.clamp(p0a.long()[:, None] + lane, max=e - 1)
    return y[pos], off


def window_rows(y: torch.Tensor, pos0: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, J=k+SLACK, H) rows y[p0a[b] : p0a[b]+J] (clamped at the last row)
    and the (B,) int32 offsets of the true window starts.  y (E, H) of any
    type, contiguous; pos0 (B,) integer window starts >= 0, int32 or int64,
    any stride."""
    devs = {y.device.type, pos0.device.type}
    if devs == {"cpu"}:
        return window_rows_plain(y, pos0, k)
    if devs != {"cuda"} or y.device != pos0.device:
        raise ValueError(
            f"window_rows: y on {y.device}, pos0 on {pos0.device}; both must "
            "be on one CUDA device (or the CPU)")
    if y.dim() != 2 or pos0.dim() != 1:
        raise ValueError(f"window_rows shapes: y {tuple(y.shape)}, pos0 "
                         f"{tuple(pos0.shape)}; want (E, H) and (B,)")
    if pos0.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"window_rows takes integer starts, got {pos0.dtype}")
    if not y.is_contiguous():
        raise ValueError("window_rows needs a contiguous table")
    e, h = y.shape
    b = pos0.shape[0]
    j = k + SLACK
    rows = torch.empty((b, j, h), dtype=y.dtype, device=y.device)
    if rows.numel() == 0:  # no rows to copy (B or H is 0)
        return rows, aligned_starts(pos0, e, k)[1]
    off = torch.empty((b,), dtype=torch.int32, device=y.device)
    if e == 0:
        raise ValueError("window_rows: empty table")
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = _lib().ocn_window_rows(
        y.data_ptr(), pos0.data_ptr(), pos0.stride(0), pos0.element_size(),
        rows.data_ptr(), off.data_ptr(), e, h * y.element_size(), b, j, stream)
    if err != 0:
        raise RuntimeError(f"window gather kernel launch failed: CUDA error {err}")
    window_rows.launches += 1
    return rows, off


window_rows.launches = 0


def pad_vals(vals: torch.Tensor, off: torch.Tensor, j: int) -> torch.Tensor:
    """Shift (P, B, K) value planes into the padded window layout:
    out[p, b, off[b] + k] = vals[p, b, k], zeros elsewhere."""
    p, b, k = vals.shape
    jlane = torch.arange(j, dtype=torch.int64, device=vals.device)[None, :]
    src = jlane - off.long()[:, None]
    valid = (src >= 0) & (src < k)
    src = torch.clamp(src, 0, k - 1)
    gathered = torch.gather(vals, 2, src[None].expand(p, b, j))
    return torch.where(valid[None], gathered, 0.0)

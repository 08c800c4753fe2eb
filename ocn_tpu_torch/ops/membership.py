"""Row-wise weighted membership counts: the CUDA kernel and its plain version.

    out[..., k] = sum_s w[..., s] * [query[..., k] == ids[..., s]]

Port of the Pallas TPU kernel ocn_tpu/ops/pallas/membership.py
(``membership_counts``), which lowers the compare branch of
``_rowwise_membership`` (ops/frame.py).  On CUDA tensors the wrapper
launches ``csrc/membership.cu`` (built with nvcc for sm_90a on first use and
bound with ctypes); on CPU tensors it runs ``membership_counts_plain``, the
dense compare-and-sum.  A CUDA call launches the kernel or raises: there is
no fallback.  ``membership_counts.launches`` counts kernel launches and
``membership_counts.shapes`` counts them by (rows, Kq, Ks).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ocn_tpu_torch.utils import toolchain

# source and the TPU kernel it replaces, for reports (chip_smoke.py)
SOURCE = "ocn_tpu_torch/csrc/membership.cu"
REPLACES = "ocn_tpu/ops/pallas/membership.py:40"

_LIB = None


def build() -> str:
    """Build (or find) the kernel library; returns its path."""
    return toolchain.build_cuda("membership")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.ocn_membership_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ocn_membership_counts.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def membership_counts_plain(query: torch.Tensor, ids: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """The dense (..., Ks, Kq) compare and weighted sum over Ks
    (ocn_tpu/ops/frame.py, compare branch of _rowwise_membership)."""
    eq = ids[..., :, None] == query[..., None, :]
    return torch.where(eq, w[..., :, None], 0.0).sum(-2)


def membership_counts(query: torch.Tensor, ids: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """(..., Kq) weighted counts of ``query`` ids in the per-row ``ids``
    lists.  query (..., Kq) int32, ids (..., Ks) int32, w (..., Ks) float32,
    equal leading dims (flattened for the kernel)."""
    devs = {query.device.type, ids.device.type, w.device.type}
    if devs == {"cpu"}:
        return membership_counts_plain(query, ids, w)
    if devs != {"cuda"} or len({query.device, ids.device, w.device}) != 1:
        raise ValueError(
            f"membership_counts: tensors on {query.device}, {ids.device}, "
            f"{w.device}; all three must be on one CUDA device (or the CPU)")
    if (query.dtype, ids.dtype, w.dtype) != (torch.int32, torch.int32, torch.float32):
        raise TypeError(
            f"membership_counts takes int32/int32/float32, got "
            f"{query.dtype}/{ids.dtype}/{w.dtype}")
    if not (query.is_contiguous() and ids.is_contiguous() and w.is_contiguous()):
        raise ValueError("membership_counts needs contiguous tensors")
    lead = tuple(query.shape[:-1])
    if ids.dim() < 1 or tuple(ids.shape[:-1]) != lead or ids.shape != w.shape:
        raise ValueError(
            f"membership_counts shapes: query {tuple(query.shape)}, ids "
            f"{tuple(ids.shape)}, w {tuple(w.shape)}")
    kq, ks = query.shape[-1], ids.shape[-1]
    rows = query.numel() // kq if kq else 0
    out = torch.empty(lead + (kq,), dtype=torch.float32, device=query.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(query.device).cuda_stream
    err = _lib().ocn_membership_counts(
        query.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(),
        rows, kq, ks, stream)
    if err != 0:
        raise RuntimeError(f"membership kernel launch failed: CUDA error {err}")
    membership_counts.launches += 1
    membership_counts.shapes[(rows, kq, ks)] += 1
    return out


membership_counts.launches = 0
membership_counts.shapes = collections.Counter()

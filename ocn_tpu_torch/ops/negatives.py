"""Uniform negative links drawn against a resident CSR: the CUDA kernel and
its plain version.

The draw of the host sampler (native/graphcore.cpp ``gc_negative_sampling``,
behind ``sparse/build.py negative_sampling``) written in its ordered form:
splitmix64 is counter-based, so candidate i of ``seed`` is the pair

    u = mix(seed + (2i+1) * gamma) % n,   v = mix(seed + (2i+2) * gamma) % n

(``seed`` 0 counts as 1), accepted iff u != v and v is not in row u of the
CSR, and the result is the first ``num`` accepted pairs among the first
``num * 64 + 1024`` candidates, fewer where those run out.  On CUDA tensors
the wrapper launches ``csrc/negatives.cu`` (built with nvcc for sm_90a on
first use, bound with ctypes); on CPU tensors it runs ``negatives_plain``,
the same candidates in NumPy uint64.  A CUDA call launches the kernel or
raises: there is no fallback.  ``negatives.launches`` counts the kernels
launched (three a round), ``negatives.rounds`` the rounds of candidates run
on the card (one a call unless over-generating by ``round_size`` fell short
of ``num``), and ``negatives.short`` the calls, on either device, that
returned fewer than ``num`` links because the candidates ran out.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ocn_tpu_torch.utils import toolchain

SOURCE = "ocn_tpu_torch/csrc/negatives.cu"
# the JAX package's host sampler, which the parent's epochs waited on
REPLACES = "ocn_tpu/sparse/build.py:182"
GAMMA = 0x9E3779B97F4A7C15
# neg_count, neg_scan and neg_write
KERNELS_A_ROUND = 3

_LIB = None


def build() -> str:
    """Build (or find) the kernel library; returns its path."""
    return toolchain.build_cuda("negatives")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.ocn_negatives_blocks.argtypes = [i64]
        lib.ocn_negatives_blocks.restype = i64
        lib.ocn_negatives_round.argtypes = [
            p, p, i64, ctypes.c_uint64, i64, i64, i64, p, p, p, p, p]
        lib.ocn_negatives_round.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def max_attempts(num: int) -> int:
    """Candidates the host sampler tries before it returns short."""
    return num * 64 + 1024


def round_size(num: int) -> int:
    """Candidates a round tests: ``num`` and a margin for the rejected ones."""
    return num + num // 64 + 4096


def _mix(z: np.ndarray) -> np.ndarray:
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def negatives_plain(indptr: torch.Tensor, col: torch.Tensor, n: int, num: int,
                    seed: int) -> torch.Tensor:
    """(2, filled) int64 negatives, the kernel's rounds in NumPy: membership
    by a search of the CSR's entries as sorted keys row * n + col."""
    ip = indptr.numpy().astype(np.int64)
    keys = (np.repeat(np.arange(n, dtype=np.int64), np.diff(ip)) * n
            + col.numpy()[:ip[-1]].astype(np.int64))
    s = np.uint64(seed or 1)
    limit, size = max_attempts(num), round_size(num)
    out, got, c0 = [], 0, 0
    with np.errstate(over="ignore"):
        while got < num and c0 < limit:
            count = min(size, limit - c0)
            k = np.arange(2 * c0 + 1, 2 * (c0 + count) + 1, dtype=np.uint64)
            z = _mix(s + k * np.uint64(GAMMA)) % np.uint64(n)
            u, v = z[0::2].astype(np.int64), z[1::2].astype(np.int64)
            key = u * n + v
            at = np.minimum(np.searchsorted(keys, key), max(keys.size - 1, 0))
            ok = u != v
            if keys.size:
                ok &= keys[at] != key
            out.append(np.stack([u[ok], v[ok]]))
            got += int(ok.sum())
            c0 += count
    pairs = np.concatenate(out, axis=1)[:, :num] if out else np.empty((2, 0), np.int64)
    return torch.as_tensor(np.ascontiguousarray(pairs))


def _launch_round(indptr, col, n, seed, c0, count, num, out, counts, offsets,
                  total) -> None:
    """One round of candidates [c0, c0 + count) on the current stream."""
    stream = torch.cuda.current_stream(indptr.device).cuda_stream
    err = _lib().ocn_negatives_round(
        indptr.data_ptr(), col.data_ptr(), n, seed, c0, count, num,
        out.data_ptr(), counts.data_ptr(), offsets.data_ptr(), total.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"negatives kernel launch failed: CUDA error {err}")
    negatives.launches += KERNELS_A_ROUND


def negatives(indptr: torch.Tensor, col: torch.Tensor, n: int, num: int,
              seed: int) -> torch.Tensor:
    """(2, filled) int64 negative links of ``seed`` against the CSR
    (``indptr`` (n + 1,) int32, ``col`` int32, rows sorted and free of
    duplicates and self-loops); filled is ``num`` unless the candidates ran
    out.  Each round reads its total back, so a CUDA call synchronises."""
    if indptr.dim() != 1 or indptr.shape[0] != n + 1 or n < 1:
        raise ValueError(f"negatives: indptr {tuple(indptr.shape)} for {n} nodes")
    if not 0 <= seed < 2**64 or num < 0:
        raise ValueError(f"negatives: seed {seed}, num {num}")
    devs = {indptr.device.type, col.device.type}
    if devs == {"cpu"}:
        out = negatives_plain(indptr, col, n, num, seed)
        negatives.short += int(out.shape[1] < num)
        return out
    if devs != {"cuda"} or indptr.device != col.device:
        raise ValueError(
            f"negatives: tensors on {indptr.device}, {col.device}; both must be "
            f"on one CUDA device (or the CPU)")
    if (indptr.dtype, col.dtype) != (torch.int32, torch.int32):
        raise TypeError(f"negatives takes int32 indptr and col, got "
                        f"{indptr.dtype}/{col.dtype}")
    if not (indptr.is_contiguous() and col.is_contiguous()):
        raise ValueError("negatives needs contiguous tensors")
    dev = indptr.device
    out = torch.empty((2, num), dtype=torch.int64, device=dev)
    if num == 0:
        return out
    limit, size = max_attempts(num), round_size(num)
    nblocks = _lib().ocn_negatives_blocks(size)
    counts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    offsets = torch.empty(nblocks, dtype=torch.int64, device=dev)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    got, c0 = 0, 0
    with torch.cuda.device(dev):
        while got < num and c0 < limit:
            count = min(size, limit - c0)
            _launch_round(indptr, col, n, seed, c0, count, num, out, counts,
                          offsets, total)
            negatives.rounds += 1
            c0 += count
            got = int(total.item())
    if got >= num:
        return out
    negatives.short += 1
    return out[:, :got]


negatives.launches = 0
negatives.rounds = 0
negatives.short = 0

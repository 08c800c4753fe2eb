"""Port parity: the membership op.  The JAX side is the Pallas kernel in
interpret mode and ``_rowwise_membership`` (both lowerings); the port side
is the wrapper's plain version (CPU tensors) and ``_rowwise_membership``.
The CUDA kernel itself is checked on the card by tests/test_torch_cuda.py
and by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.ops import frame as jframe
from ocn_tpu.ops.pallas.membership import membership_counts as jax_membership
from ocn_tpu_torch.ops import frame as tframe
from ocn_tpu_torch.ops import membership as tm
from torch_parity import one_thread  # noqa: F401 (autouse: one intra-op thread)


def _inputs(rng, lead, kq, ks, n, unit_w, sort=True):
    q = rng.integers(0, n, size=lead + (kq,)).astype(np.int32)
    ids = rng.integers(0, n, size=lead + (ks,)).astype(np.int32)
    if sort:
        ids = np.sort(ids, axis=-1)
    w = (np.ones(lead + (ks,), np.float32) if unit_w
         else rng.random(lead + (ks,)).astype(np.float32))
    return q, ids, w


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("b,kq,ks,n,unit_w", [
    (512, 64, 64, 1000, False),   # test_pallas main case
    (300, 16, 32, 77, True),      # ragged tile, many duplicates
    (256, 64, 16, 500, False),    # k2_dst-style narrow list
])
def test_plain_matches_pallas_interpret(rng, b, kq, ks, n, unit_w):
    q, ids, w = _inputs(rng, (b,), kq, ks, n, unit_w, sort=False)
    want = np.asarray(jax_membership(jnp.asarray(q), jnp.asarray(ids),
                                     jnp.asarray(w), interpret=True))
    before = tm.membership_counts.launches
    got = tm.membership_counts(*_t(q, ids, w)).numpy()
    assert tm.membership_counts.launches == before  # CPU: no kernel launch
    if unit_w:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lead,kq,ks", [
    ((64,), 64, 64),        # compare branch
    ((16, 5), 32, 48),      # compare branch with (B, R, K) leading dims
    ((40,), 256, 256),      # binary-search branch (kq*ks > 32768)
    ((6, 4), 200, 300),     # binary-search branch with leading dims
])
def test_rowwise_membership_matches(rng, lead, kq, ks):
    q, ids, w = _inputs(rng, lead, kq, ks, 400, unit_w=False)
    want = np.asarray(jframe._rowwise_membership(
        jnp.asarray(q), jnp.asarray(ids), jnp.asarray(w)))
    got = tframe._rowwise_membership(*_t(q, ids, w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_rowwise_membership_broadcast_query(rng):
    # the blocked recursion passes a query broadcast over the candidate axis
    q, _, _ = _inputs(rng, (8, 1), 24, 1, 100, True)
    _, ids, w = _inputs(rng, (8, 6), 24, 40, 100, False)
    want = np.asarray(jframe._rowwise_membership(
        jnp.asarray(q), jnp.asarray(ids), jnp.asarray(w)))
    got = tframe._rowwise_membership(*_t(q, ids, w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kq,ks", [(8, 16), (256, 256)])
def test_duplicate_semantics_per_branch(kq, ks):
    # compare branch: duplicates add; binary search: the FIRST match only
    q = np.zeros((2, kq), np.int32)
    q[:, 0] = 5
    ids = np.full((2, ks), 9, np.int32)
    ids[:, :3] = 5
    w = np.arange(1, 2 * ks + 1, dtype=np.float32).reshape(2, ks)
    want = np.asarray(jframe._rowwise_membership(
        jnp.asarray(q), jnp.asarray(ids), jnp.asarray(w)))
    got = tframe._rowwise_membership(*_t(q, ids, w)).numpy()
    np.testing.assert_array_equal(got, want)
    expect = w[:, :3].sum(-1) if kq * ks <= tframe._COMPARE_LIMIT else w[:, 0]
    np.testing.assert_array_equal(got[:, 0], expect)


def test_non_cpu_non_cuda_tensors_raise():
    q = torch.zeros(4, 8, dtype=torch.int32, device="meta")
    ids = torch.zeros(4, 8, dtype=torch.int32, device="meta")
    w = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tm.membership_counts(q, ids, w)

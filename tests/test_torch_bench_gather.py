"""Port parity: the row-gather instrument (ocn_tpu_torch/scripts/
bench_gather.py) and the plain versions of its kernels (ops/row_gather.py,
ops/window_gather.py), against the JAX expressions of scripts/bench_gather.py.

The Pallas kernels of that script sit inside its main() and need a TPU, so
each plain version is held against the expression it replaces: ``x[idx]``
(g_xla), ``ytab[pos]`` at the script's 8-aligned ``p0`` (what gather_w
copies), and kern2's body, the one-hot matmul per tile.  All are copies of
bfloat16 rows: equal bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu_torch.ops import row_gather as RG
from ocn_tpu_torch.ops import window_gather as W
from ocn_tpu_torch.scripts import bench_gather as G
from torch_parity import one_thread  # noqa: F401 (autouse: one intra-op thread)


def _bits(a) -> np.ndarray:
    """bfloat16 values as their 16-bit patterns (torch or JAX)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _table(rng, n, h):
    a = rng.standard_normal((n, h))
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("itype", [np.int32, np.int64])
def test_row_rows_plain_matches_x_idx(sort, itype):
    rng = np.random.default_rng(1)
    n, h, m = 500, 24, 3000
    jx, tx = _table(rng, n, h)
    idx = rng.integers(0, n, size=m).astype(itype)
    idx[[5, 77]] = [n, n + 1000]  # out of range: XLA clamps to the last row
    if sort:
        idx = np.sort(idx)
    want = jx[jnp.asarray(idx)]  # g_xla's gather, bench_gather.py:49
    tidx = torch.from_numpy(idx)
    got = RG.row_rows_plain(tx, tidx)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # on CPU tensors the wrapper is the plain version, and launches nothing
    before = RG.row_rows.launches
    np.testing.assert_array_equal(_bits(RG.row_rows(tx, tidx)), _bits(want))
    assert RG.row_rows.launches == before


def test_window_rows_plain_matches_ytab_at_the_script_p0():
    rng = np.random.default_rng(2)
    e2, h, b2, k2 = 5000, 16, 300, 64
    j = k2 + W.SLACK
    jy, ty = _table(rng, e2, h)
    pos0 = rng.integers(0, e2 - k2, size=(b2,), dtype=np.int32)
    pos0[:2] = [0, e2 - k2 - 1]  # the last window's start clamps at e2 - j
    p0 = np.minimum((pos0 // 8) * 8, e2 - j).astype(np.int32)  # :119
    want = jy[jnp.asarray(p0)[:, None] + jnp.arange(j)]  # what gather_w copies
    rows, off = W.window_rows_plain(ty, torch.from_numpy(pos0), k2)
    np.testing.assert_array_equal(_bits(rows.reshape(b2 * j, h)),
                                  _bits(want.reshape(b2 * j, h)))
    np.testing.assert_array_equal(off.numpy(), pos0 - p0)


def _kern2(jx, ids, bases, ts, w):
    """kern2's body (bench_gather.py:189-199) per tile, in JAX."""
    out = []
    for t, base in enumerate(bases):
        lane = jnp.arange(w)[None, :]
        tile = jnp.asarray(ids[t * ts:(t + 1) * ts])[:, None]
        onehot = (lane + int(base) == tile).astype(jnp.bfloat16)
        xb = jx[int(base):int(base) + w]
        out.append(jnp.dot(onehot, xb, preferred_element_type=jnp.float32)
                   .astype(jnp.bfloat16))
    return jnp.concatenate(out)


def test_sorted_block_rows_plain_matches_the_one_hot_body():
    rng = np.random.default_rng(3)
    n, h, ts, w = 400, 8, 32, 96
    jx, tx = _table(rng, n, h)
    ids = np.sort(rng.integers(0, n, size=(8 * ts,), dtype=np.int32))
    ids[-ts:] = np.sort(rng.integers(n - 20, n, size=ts))  # last tile at n - w
    bases = G.tile_bases(ids, n, ts, w)
    assert bases[-1] == n - w  # the clamp binds
    # ids outside their tile's block: past its end, and below its base
    ids[ts + 3] = bases[1] + w + 5
    ids[2 * ts + 1] = bases[2] - 1
    want = _kern2(jx, ids, bases, ts, w)
    inside = (ids >= np.repeat(bases, ts)) & (ids < np.repeat(bases, ts) + w)
    assert (~inside).sum() == 2 and not np.any(np.asarray(want, np.float32)[~inside])
    got = RG.sorted_block_rows(tx, torch.from_numpy(ids), torch.from_numpy(bases),
                               ts, w)
    np.testing.assert_array_equal(np.asarray(want, np.float32), got.float().numpy())
    np.testing.assert_array_equal(_bits(got)[inside], _bits(want)[inside])


def test_sorted_block_rows_wrapper_checks_the_tiles():
    x = torch.zeros(10, 4)
    with pytest.raises(ValueError, match="bases"):
        RG.sorted_block_rows(x, torch.zeros(9, dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32), 4, 4)


def test_draws_equal_the_script_numpy_calls():
    m, n, h, e2, b2, k2 = 1000, 300, 8, 2000, 50, 64
    idx, tx, ty, pos0 = G.draw(m, n, h, e2, b2, k2, seed=0)
    # bench_gather.py:39-43 and :117-118, in that order
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(idx, rng.integers(0, n, size=(m,), dtype=np.int32))
    x = jnp.asarray(rng.standard_normal((n, h)), jnp.bfloat16)
    yt = jnp.asarray(rng.standard_normal((e2, h)), jnp.bfloat16)
    np.testing.assert_array_equal(pos0, rng.integers(0, e2 - k2, size=(b2,),
                                                     dtype=np.int32))
    np.testing.assert_array_equal(_bits(tx), _bits(x))
    np.testing.assert_array_equal(_bits(ty), _bits(yt))
    # drawing in row blocks continues one stream
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    whole = jnp.asarray(r1.standard_normal((100, 8)), jnp.bfloat16)
    blocks = G.normal_bf16(r2, 100, 8, "cpu", block=7)
    np.testing.assert_array_equal(_bits(blocks), _bits(whole))


def test_the_script_span_check_at_its_shapes():
    """The script's seed-0 ids at full size: its widest tile spans 2,303
    rows, under W = 2,304, so the one-hot variant runs."""
    s = G.SIZES
    idx = np.random.default_rng(0).integers(0, s["n"], size=(s["m"],),
                                             dtype=np.int32)
    srt = np.sort(idx)
    bases = G.tile_bases(srt, s["n"], s["ts"], s["w"])
    assert int((srt.reshape(-1, s["ts"])[:, -1] - bases).max()) == 2303
    # the bound's distinct rows (PERF.md)
    assert np.unique(idx).size == 158154


def test_main_on_cpu_at_a_small_size(capsys):
    out = G.main(device="cpu", iters=1, warmup=0, m=2048, n=1500, h=16, e2=9000,
                 b2=64, k2=64, ts=256, w=512)
    names = ["xla", "xla_sorted", "pallas", "pallas_srt", "window_xla",
             "window_dma", "onehot_mxu"]
    assert list(out["variants"]) == names and out["span"] < 512
    assert out["device"] == "cpu"
    printed = capsys.readouterr().out.split()
    assert all(name in printed for name in names)
    for v in out["variants"].values():
        assert v["ms"] > 0 and v["bound_ms"] > 0

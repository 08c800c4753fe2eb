"""Port parity: cn6, the 3-hop predictor — ops/ortho.py orthogonalize3,
ops/frame.py cn3_frame, nn/predictors/cn_3hop.py and the trainer's A^3
path (the host A^3 build, its ELL table tbl3, eval through it).

orthogonalize3 runs a multi-step EMA sequence on both its paths (the fused
five-plane sorted-domain one and the direct oracle): values, gradients to
all three planes, and the shared-EMA quirk (n advances by 3 per training
call; both cn3 coefficients read the buffer after the third step).
Tolerances: rtol 1e-5 on the ortho pieces, 1e-4 on predictor and trainer
(float32 sums in another order, compounded over steps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.config import Config as JConfig
from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.nn.predictors import build_predictor as jbuild
from ocn_tpu.ops import frame as jf
from ocn_tpu.ops import ortho as jo
from ocn_tpu.sparse.csr import graph_from_numpy as jgraph
from ocn_tpu.train.loop import Trainer as JTrainer
from ocn_tpu_torch.config import Config as TConfig
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.nn.predictors import build_predictor as tbuild
from ocn_tpu_torch.ops import frame as tf
from ocn_tpu_torch.ops import ortho as to
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.sparse.csr import graph_from_numpy as tgraph
from ocn_tpu_torch.train.loop import Trainer as TTrainer
from ocn_tpu_torch.weights import load_predictor
from torch_parity import frame_steps, predictor_sequence, trajectory, without_window
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

TOL = dict(rtol=1e-5, atol=1e-6)


def _planes(seed, b=20, k=10, n=40):
    """Shared sorted ids with sentinel lanes and three value planes from
    {0, 0.5, 1, 2}, so some cn1 columns sum to exactly 1 (the quirk)."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n + 1, size=(b, k)), axis=-1).astype(np.int32)
    levels = np.array([0.0, 0.0, 0.5, 1.0, 1.0, 2.0], np.float32)
    vals = [levels[rng.integers(0, len(levels), size=ids.shape)] for _ in range(3)]
    for v in vals:
        v[ids == n] = 0.0
    return ids, vals, n


@pytest.mark.parametrize("fused", [True, False])
def test_orthogonalize3_ema_sequence(fused):
    """Four training calls thread (ema, n), n advancing by 3 each; then one
    eval call reads the stored value.  Values and gradients to the three
    planes match; the cn3 projection uses the buffer after the third step
    for both coefficients."""
    jema, jn = jnp.zeros(()), jnp.zeros((), jnp.int32)
    tema, tn = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    for step, training in enumerate([True] * 4 + [False]):
        ids, vals, n = _planes(step)
        rng = np.random.default_rng(100 + step)
        cts = [rng.standard_normal(ids.shape).astype(np.float32) for _ in range(3)]

        def jfun(a, b, c):
            fr = [jf.CNFrame(jnp.asarray(ids), v, n) for v in (a, b, c)]
            fidx = jf.frame_index(jnp.asarray(ids), n) if fused else None
            n1, o2, o3, e, cnt = jo.orthogonalize3(*fr, jema, jn, training, 0.0, fidx)
            return (n1.val, o2.val, o3.val), (e, cnt)

        jouts, vjp, (jema, jn) = jax.vjp(
            jfun, *(jnp.asarray(v) for v in vals), has_aux=True)
        jgrads = vjp(tuple(jnp.asarray(c) for c in cts))

        ti = torch.as_tensor(ids)
        tv = [torch.as_tensor(v).requires_grad_() for v in vals]
        fidx = tf.frame_index(ti, n) if fused else None
        before = tema.clone()
        n1, o2, o3, tema, tn = to.orthogonalize3(
            *(tf.CNFrame(ti, v, n) for v in tv), tema, tn, training, 0.0, fidx)
        sum((f.val * torch.as_tensor(c)).sum()
            for f, c in zip((n1, o2, o3), cts)).backward()
        tema = tema.detach()
        for got, want in zip((n1, o2, o3), jouts):
            np.testing.assert_allclose(got.val.detach().numpy(), np.asarray(want), **TOL)
        for got, want in zip(tv, jgrads):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(float(tema), float(jema), **TOL)
        assert int(tn) == int(jn) == 3 * min(step + 1, 4)

        # the aliasing quirk, re-derived: the three running-mean steps,
        # then ocn3 from one coefficient, the buffer after the third
        with torch.no_grad():
            f = [tf.CNFrame(ti, v.detach(), n) for v in tv]
            scale = n1.val.detach().abs().max()
            m, k = before, 3 * step
            if training:
                inners = [f[1].inner(n1), f[2].inner(n1), f[2].inner(o2)]
                for ip in inners:
                    k += 1
                    m = (1 - 1 / k) * m + ip / k
            assert torch.allclose(m, tema, rtol=1e-5, atol=1e-7)
            nip = m / scale
            raw = torch.where(f[2].mask | n1.mask | o2.mask,
                              f[2].val - nip * n1.val - nip * o2.val, 0.0)
            want3 = to.colnorm_plain(f[2].with_values(raw)).val
            np.testing.assert_allclose(o3.val.detach().numpy(), want3.numpy(),
                                       rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def graph():
    ds = tsynthetic("Cora", seed=4, scale=0.1)
    n = ds.n_nodes
    ip, col = B.csr_from_edge_index(ds.edge_index, n)
    ip2, col2, val2 = B.adj2_csr(ip, col, n, cap=1024)
    n2 = int(ip2[-1])
    ip3, col3, val3 = B.spgemm_csr(ip2, col2[:n2], val2[:n2], ip, col, None, n, cap=64)
    return dict(ds=ds, n=n, ip=ip, col=col, a3=(ip3, col3, val3))


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("path", ["adj3", "sddmm"])
def test_cn3_frame_matches(graph, path, counts):
    """cn3_frame on the A^3 path (a capped A^3, rows wider than k2 take
    their first window) and on the SDDMM fallback (the test oracle), both
    against the JAX function on the same candidate frames; unit adjacency
    values, so exact."""
    n, (ip3, col3, val3) = graph["n"], graph["a3"]
    jg, tg = jgraph(graph["ip"], graph["col"], n), tgraph(graph["ip"], graph["col"], n)
    ja3 = jgraph(ip3, col3, n, val3, gather_only=True) if path == "adj3" else None
    ta3 = tgraph(ip3, col3, n, val3, gather_only=True) if path == "adj3" else None
    k, k2, k3 = 16, 8, 8
    assert int(np.diff(ip3).max()) > k2 and int(np.diff(graph["ip"]).max()) > k
    rng = np.random.default_rng(1)
    tar = np.concatenate([graph["ds"].split_edge["train"]["edge"][:40].T,
                          rng.integers(0, n, size=(2, 30))], axis=1)
    jsrc = jf.gather_neighbors(jg, jnp.asarray(tar[0]), k)
    tsrc = tf.gather_neighbors(tg, torch.as_tensor(tar[0]), k)
    want = jf.cn3_frame(jg, jnp.asarray(tar), jsrc, k2=k2, k3=k3, chunk=32,
                        counts=counts, adj3=ja3)
    got = tf.cn3_frame(tg, torch.as_tensor(tar), tsrc, k2=k2, k3=k3, chunk=32,
                       counts=counts, adj3=ta3)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))
    assert (got.val != 0).any() and (got.val == 0).any()


@pytest.fixture(scope="module")
def steps():
    return frame_steps(three_hop=True)


@pytest.mark.parametrize("ln,window", [(True, True), (False, False)])
def test_ocn3hop_predictor_matches(steps, ln, window):
    kw = dict(dropout=0.0, ln=ln, tailact=True, use_xlin=True, beta=0.8)
    tp = predictor_sequence("cn6", kw, steps if window else without_window(steps))
    assert int(tp.n) == 9  # three training chunks, three EMA steps each


def test_params_from_jax_rejects_unmapped(steps):
    s0 = steps[0]
    jp = jbuild("cn6", 16, s0["n"])
    v = jax.device_get(jp.init({"params": jax.random.PRNGKey(0)},
                               jnp.asarray(s0["x"]), s0["jg"], *s0["jframes"],
                               jnp.asarray(s0["tar"]), False))
    tp = tbuild("cn6", 16, 16, n_nodes=s0["n"])
    load_predictor(tp, v["params"], v["ema"])
    assert "CNAggMLP_2" in v["params"]
    for key in ("CNAggMLP_3", "Extra_0", "xcn1_w1"):
        with pytest.raises(KeyError, match=key):
            load_predictor(tp, {**v["params"], key: v["params"]["alpha"]}, v["ema"])
    with pytest.raises(KeyError, match="extra"):
        load_predictor(tp, v["params"], {**v["ema"], "extra": np.zeros(())})


# cn6 on ELL tables (tbl3 on, every capped row frozen by NumPy offsets on
# both sides) with the dual-K split: small body at k_small, big at pad_deg;
# eval through the tables (ell_eval) and dual-K.  Learning rates 1e-3: Adam
# divides each gradient by its own running scale, so float-order noise in a
# near-zero gradient becomes a step of up to lr, and at 1e-2 cn6's steps
# drift the encoder enough to move eval scores across a Hits threshold
KW = dict(model="gcn", mplayers=2, hiddim=16, ln=True, res=True, jk=True,
          use_xlin=True, tailact=True, lnnn=True, gnndp=0.0, xdp=0.0, tdp=0.0,
          gnnedp=0.0, predp=0.0, preedp=0.0, gnnlr=0.001, prelr=0.001,
          ell_tables=True, k_small=4, maskinput=True, batch_size=64,
          linkbatchsize=16, testbs=64, pad_deg=16, pad_deg2=8, adj3_cap=64,
          predictor="cn6", window_table=True)


@pytest.fixture(scope="module")
def cora():
    return (jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs(),
            tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs())


def test_a3_build_and_table_match(cora):
    jt = JTrainer(JConfig(**KW), cora[0])
    tt = TTrainer(TConfig(**KW), cora[1], device="cpu")
    assert tt._k3_width() == jt._k3_width() == 8
    for name in ("indptr", "deg", "packed"):
        np.testing.assert_array_equal(getattr(tt.adj3, name).numpy(),
                                      np.asarray(getattr(jt.adj3, name)))
    assert tt.adj3.col_bits == jt.adj3.col_bits
    assert int(tt.adj3.deg.max()) > tt._k3_width()  # capped rows exist
    # tbl3's offsets are drawn after off1 and off2 from the same generator
    jt._refresh_ell(np.random.default_rng(3))
    tt._refresh_ell(np.random.default_rng(3))
    for name in ("tbl1", "tbl2", "tbl3", "off3"):
        np.testing.assert_array_equal(tt._ell[name].numpy(), np.asarray(jt._ell[name]))
    # the split still rounds to whole frame groups, though cn6 is never grouped
    for grp in (1, 2, 4):
        kw = dict(KW, frame_group=grp, batch_size=256)
        assert (TTrainer(TConfig(**kw), cora[1], device="cpu")._split
                == JTrainer(JConfig(**kw), cora[0])._split)


def test_cn6_trajectory_matches_jax(cora, monkeypatch):
    """Five steps, an epoch and evaluate: three membership lookups per chunk
    (cn1, cn2, cn3), one chunk at a time even with frame_group > 1."""
    calls = []
    real = tf.membership_counts

    def counting(q, ids, w):
        calls.append((q.shape[0], q.shape[1], ids.shape[1]))
        return real(q, ids, w)

    monkeypatch.setattr(tf, "membership_counts", counting)
    kw = dict(KW, frame_group=2)
    seen = []

    def on_step(tt):
        seen.append(list(calls))
        calls.clear()

    jt, _, tt, ts = trajectory(kw, *cora, on_step=on_step)
    c = kw["linkbatchsize"]
    nsp, nsn = tt._split
    nchunk = 2 * kw["batch_size"] // c
    for step in seen[1:]:
        assert len(step) == 3 * nchunk
        # the small body's chunks query at k_small, cn3 against k3 lanes
        assert step[:3] == [(c, 4, 8), (c, 4, 8), (c, 4, 8)]
        assert step[-3:] == [(c, 16, 8), (c, 16, 8), (c, 16, 8)]
    assert nsp + nsn > 0

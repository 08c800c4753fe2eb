"""Port parity: the trainer (train/loop.py) end to end.

Both packages train cn5 on the same small graph from the same initial
parameters (copied out of the JAX state with weights.params_from_jax):
five explicit steps on identical batches, then one train_epoch drawing its
permutation and negatives from the same NumPy generator, then evaluate.
Dropout is 0 and every degree is under the frame caps (asserted), so no
random stream is read.  Tolerance rtol=1e-4: Adam and the segment sums
accumulate in a different order on the two sides, and the differences
compound over the steps."""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.config import Config as JConfig
from ocn_tpu.data.loaders import loaddataset as jloaddataset
from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.train.loop import Trainer as JTrainer
from ocn_tpu_torch import cli as tcli
from ocn_tpu_torch.config import Config as TConfig
from ocn_tpu_torch.config import presets as tpresets
from ocn_tpu_torch.data.loaders import loaddataset as tloaddataset
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.nn.mlp import dropout as tdropout
from ocn_tpu_torch.ops import frame as tframe
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.train.loop import Trainer as TTrainer
from ocn_tpu_torch.weights import params_from_jax

KW = dict(model="gcn", mplayers=2, hiddim=16, ln=True, res=True, jk=True,
          use_xlin=True, tailact=True, lnnn=True, gnndp=0.0, xdp=0.0, tdp=0.0,
          gnnedp=0.0, predp=0.0, preedp=0.0, gnnlr=0.01, prelr=0.01,
          ell_tables=False, k_small=0, maskinput=True, batch_size=64,
          linkbatchsize=32, testbs=64, pad_deg=32, pad_deg2=96)
RTOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jds = jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs()
    tds = tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs()
    jt = JTrainer(JConfig(**KW), jds)
    tt = TTrainer(TConfig(**KW), tds, device="cpu")
    # no capped row anywhere: the runs read no random stream
    assert int(tt.g.deg.max()) <= KW["pad_deg"]
    assert int(tt.adj2.deg.max()) <= KW["pad_deg2"]
    np.testing.assert_array_equal(tt.edge2pos, jt.edge2pos)
    js = jt.init_state(0)
    ts = tt.init_state(0)
    # host copies: the JAX step donates its state
    init = jax.device_get((js.params, js.ema))
    params_from_jax(*init, ts.encoder, ts.predictor)
    return jt, js, tt, ts, init


def test_trajectory_epoch_and_hits(pair):
    jt, js, tt, ts, _ = pair
    e = tt.train_edges.shape[1]
    rng = np.random.default_rng(5)
    perm = rng.permutation(e)
    neg = B.negative_sampling(tt.ds.edge_index, tt.ds.n_nodes, e, rng)
    bs = KW["batch_size"]
    assert e >= 5 * bs
    gen = torch.Generator().manual_seed(0)
    jl, tl = [], []
    for i in range(5):
        idx = perm[i * bs:(i + 1) * bs]
        pos_b, neg_b = tt.train_edges[:, idx], neg[:, idx]
        pe, ne, mp, ip, inn = jt.prepare_batch(pos_b, neg_b, idx)
        js, loss = jt.train_step(js, pe, ne, mp, jax.random.PRNGKey(i), ip, inn)
        jl.append(float(loss))
        pe, ne, mp, ip, inn = tt.prepare_batch(pos_b, neg_b, idx)
        assert ip is None and inn is None  # k_small=0: no split
        ts, loss = tt.train_step(ts, pe, ne, mp, gen, ip, inn)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert len(set(jl)) == 5  # the loss moves: the steps really train

    # one epoch: permutation, negatives and the per-epoch seed come from the
    # same generator on both sides, in the same order
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    js, jloss = jt.train_epoch(js, rj, 1)
    ts, tloss = tt.train_epoch(ts, rt, 1)
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL)
    assert rj.integers(2**31) == rt.integers(2**31)

    # the EMA inner product advanced once per chunk, positives then negatives
    ema = jax.device_get(js.ema)
    chunks = 2 * bs // KW["linkbatchsize"]
    assert int(ts.predictor.n) == int(ema["n"]) == chunks * (5 + e // bs)
    np.testing.assert_allclose(float(ts.predictor.innerprod),
                               float(ema["innerprod"]), rtol=RTOL)

    want = jt.evaluate(js)
    got = tt.evaluate(ts)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    # eval scores themselves, tail batch padded (the valid split is ragged)
    edges = tt.ds.split_edge["valid"]["edge"]
    assert edges.shape[0] % KW["testbs"]
    jscore = jt._score_batches(js, jt.encode(js.params, jt.g), jt.g,
                               edges, jt.adj2)
    tscore = tt._score_batches(ts, tt.encode(ts), tt.g, edges, tt.adj2)
    np.testing.assert_allclose(tscore, jscore, rtol=RTOL, atol=1e-5)


# the window-table path: ELL tables (refreshed per epoch), the dual-K split
# and window_table together; pad_deg2 <= pad_deg, so every neighbor gather
# rides a table, and capped rows are in (their windows are frozen in the
# tables, with offsets drawn by NumPy on both sides)
KW_WINDOW = dict(KW, ell_tables=True, k_small=4, window_table=True,
                 pad_deg=16, pad_deg2=8, linkbatchsize=16)


def test_window_ell_dual_k_trajectory():
    jds = jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs()
    tds = tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs()
    jt = JTrainer(JConfig(**KW_WINDOW), jds)
    tt = TTrainer(TConfig(**KW_WINDOW), tds, device="cpu")
    assert tt._use_ell and jt._use_ell
    assert tt._split == jt._split and min(tt._split) > 0
    assert int(tt.g.deg.max()) > KW_WINDOW["pad_deg"]
    assert int(tt.adj2.deg.max()) > KW_WINDOW["pad_deg2"]
    js = jt.init_state(0)
    ts = tt.init_state(0)
    params_from_jax(*jax.device_get((js.params, js.ema)), ts.encoder, ts.predictor)
    jt._refresh_ell(np.random.default_rng(7))
    tt._refresh_ell(np.random.default_rng(7))

    e = tt.train_edges.shape[1]
    rng = np.random.default_rng(5)
    perm = rng.permutation(e)
    neg = B.negative_sampling(tt.ds.edge_index, tt.ds.n_nodes, e, rng)
    bs = KW_WINDOW["batch_size"]
    gen = torch.Generator().manual_seed(0)
    jl, tl = [], []
    for i in range(5):
        idx = perm[i * bs:(i + 1) * bs]
        pos_b, neg_b = tt.train_edges[:, idx], neg[:, idx]
        pe, ne, mp, ip, inn = jt.prepare_batch(pos_b, neg_b, idx)
        js, loss = jt.train_step(js, pe, ne, mp, jax.random.PRNGKey(i), ip, inn)
        jl.append(float(loss))
        pe, ne, mp, ip, inn = tt.prepare_batch(pos_b, neg_b, idx)
        assert isinstance(mp, dict) and "ell_flat" in mp and ip.shape == (bs,)
        ts, loss = tt.train_step(ts, pe, ne, mp, gen, ip, inn)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert len(set(jl)) == 5

    # one epoch: the tables are rebuilt from the epoch-derived generator
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    js, jloss = jt.train_epoch(js, rj, 1)
    ts, tloss = tt.train_epoch(ts, rt, 1)
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL)
    np.testing.assert_array_equal(tt._ell["tbl1"].numpy(),
                                  np.asarray(jt._ell["tbl1"]))

    # the EMA advanced once per chunk, in the order [pos_s, neg_s, pos_b,
    # neg_b] (the inner product is a running mean, so the order shows in it)
    ema = jax.device_get(js.ema)
    chunks = 2 * bs // KW_WINDOW["linkbatchsize"]
    assert int(ts.predictor.n) == int(ema["n"]) == chunks * (5 + e // bs)
    np.testing.assert_allclose(float(ts.predictor.innerprod),
                               float(ema["innerprod"]), rtol=RTOL)

    # eval through the tables, dual-K on the splits larger than testbs
    assert e > KW_WINDOW["testbs"]
    want = jt.evaluate(js)
    got = tt.evaluate(ts)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


@pytest.mark.filterwarnings("ignore:dataset 'Cora' unavailable offline")
def test_window_dual_k_eval_on_the_full_graph():
    """use_valedges_as_input: the test split is scored on the train+valid
    graph, which carries no ELL table; its window table is built from that
    graph's col and its dual-K routing reads that graph's degrees.  Capped
    rows there take the first-k window (eval_sampling off), so no random
    stream is read."""
    kw = dict(KW_WINDOW, use_valedges_as_input=True, eval_sampling=False,
              testbs=8)
    jds = jloaddataset("Cora", True, synthetic_scale=0.1).reorder_bfs()
    tds = tloaddataset("Cora", True, synthetic_scale=0.1).reorder_bfs()
    jt = JTrainer(JConfig(**kw), jds)
    tt = TTrainer(TConfig(**kw), tds, device="cpu")
    js = jt.init_state(0)
    ts = tt.init_state(0)
    params_from_jax(*jax.device_get((js.params, js.ema)), ts.encoder, ts.predictor)
    jt._refresh_ell(np.random.default_rng(7))
    tt._refresh_ell(np.random.default_rng(7))

    test = tt.ds.split_edge["test"]["edge"]
    assert test.shape[0] > kw["testbs"]  # the dual-K eval runs
    # some test sources cross k_small once the valid edges are added, and
    # the train graph's degrees would route every one of them to the small
    # body (their count fills whole testbs batches)
    src = test[:, 0]
    d_train, d_full = tt.g.deg.numpy()[src], tt.full_g.deg.numpy()[src]
    assert ((d_train <= kw["k_small"]) & (d_full > kw["k_small"])).any()
    assert np.sum(d_train <= kw["k_small"]) % kw["testbs"] == 0

    jh = jt._eval_encode(js, full=True)
    th = tt.encode(ts, full=True)
    want = jt._score_split(js, jh, jt.full_g, test, jt.full_adj2)
    got = tt._score_split(ts, th, tt.full_g, test, tt.full_adj2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    want = jt.evaluate(js)
    got = tt.evaluate(ts)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


def test_collab_preset_with_window_table_trains_on_cpu():
    """presets("collab", "cn5") with the window table, cut to a small graph
    and batch: ELL tables, dual-K split and window gathers all run."""
    ds = tsynthetic("collab", seed=0, scale=0.002).reorder_bfs()
    cfg = TConfig(**{**dataclasses.asdict(tpresets("collab", "cn5", window_table=True)),
                     "batch_size": 256, "linkbatchsize": 64, "testbs": 512,
                     "hiddim": 32})
    tr = TTrainer(cfg, ds, device="cpu")
    assert tr._use_ell and tr._split is not None
    state = tr.init_state(0)
    state, loss = tr.train_epoch(state, np.random.default_rng(0), 1)
    assert np.isfinite(loss) and tr._ell is not None
    for vals in tr.evaluate(state).values():
        assert all(0.0 <= v <= 1.0 for v in vals)


@pytest.fixture(scope="module")
def cora():
    return (jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs(),
            tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs())


@pytest.mark.parametrize("frame_group,small_frac,small_frac_neg", [
    (1, -1.0, -1.0),     # auto fractions, no groups
    (8, -1.0, -1.0),     # the bench's group, auto fractions
    (2, 0.5, 0.3125),    # 8 + 5 chunks: the larger side gives one, 7 + 5
    (4, 0.375, 0.5),     # 6 + 8: negatives give two, 6 + 6
    (5, 0.75, 0.75),     # 12 + 12: ties take turns, negatives first, 10 + 10
    (8, 0.0625, 0.0),    # 1 + 0 rounds to nothing: no split
])
def test_split_plan_matches_jax(cora, frame_group, small_frac, small_frac_neg):
    kw = dict(KW, ell_tables=True, k_small=4, pad_deg=16, pad_deg2=8,
              batch_size=256, linkbatchsize=16, frame_group=frame_group,
              small_frac=small_frac, small_frac_neg=small_frac_neg)
    jt = JTrainer(JConfig(**kw), cora[0])
    tt = TTrainer(TConfig(**kw), cora[1], device="cpu")
    assert tt._split == jt._split
    if small_frac >= 0:
        want = {2: (7, 5), 4: (6, 6), 5: (10, 10), 8: None}[frame_group]
        assert tt._split == want


# the bench program's grouped frames in small: ELL tables, the dual-K split
# at a split that the group rounding moves ((2, 1) chunks become (1, 1)),
# bfloat16 features; the big body's 6 chunks run as 3 groups of 2
KW_GROUPED = dict(KW_WINDOW, frame_group=2, small_frac=0.5,
                  small_frac_neg=0.25, dtype="bfloat16")


@pytest.mark.parametrize("window_table", [False, True])
def test_grouped_bf16_trajectory(cora, monkeypatch, window_table):
    kw = dict(KW_GROUPED, window_table=window_table)
    jt = JTrainer(JConfig(**kw), cora[0])
    tt = TTrainer(TConfig(**kw), cora[1], device="cpu")
    assert tt._split == jt._split == (1, 1)
    assert TTrainer(TConfig(**dict(kw, frame_group=1)), cora[1],
                    device="cpu")._split == (2, 1)
    js = jt.init_state(0)
    ts = tt.init_state(0)
    params_from_jax(*jax.device_get((js.params, js.ema)), ts.encoder, ts.predictor)
    jt._refresh_ell(np.random.default_rng(7))
    tt._refresh_ell(np.random.default_rng(7))

    # membership runs once for cn1 and once for cn2 per frame group, at the
    # group's rows
    rows = []
    real = tframe.membership_counts

    def counting(q, *args):
        rows.append(q.shape[0])
        return real(q, *args)

    monkeypatch.setattr(tframe, "membership_counts", counting)
    e = tt.train_edges.shape[1]
    rng = np.random.default_rng(5)
    perm = rng.permutation(e)
    neg = B.negative_sampling(tt.ds.edge_index, tt.ds.n_nodes, e, rng)
    bs, c = kw["batch_size"], kw["linkbatchsize"]
    gen = torch.Generator().manual_seed(0)
    jl, tl = [], []
    for i in range(5):
        idx = perm[i * bs:(i + 1) * bs]
        pos_b, neg_b = tt.train_edges[:, idx], neg[:, idx]
        pe, ne, mp, ip, inn = jt.prepare_batch(pos_b, neg_b, idx)
        js, loss = jt.train_step(js, pe, ne, mp, jax.random.PRNGKey(i), ip, inn)
        jl.append(float(loss))
        rows.clear()
        pe, ne, mp, ip, inn = tt.prepare_batch(pos_b, neg_b, idx)
        ts, loss = tt.train_step(ts, pe, ne, mp, gen, ip, inn)
        tl.append(float(loss))
        assert rows == [2 * c] * 8  # 1 small group + 3 big groups, 2 each
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert len(set(jl)) == 5

    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    js, jloss = jt.train_epoch(js, rj, 1)
    ts, tloss = tt.train_epoch(ts, rt, 1)
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL)
    # the EMA still advances once per chunk
    ema = jax.device_get(js.ema)
    assert int(ts.predictor.n) == int(ema["n"]) == 2 * bs // c * (5 + e // bs)
    np.testing.assert_allclose(float(ts.predictor.innerprod),
                               float(ema["innerprod"]), rtol=RTOL)
    want = jt.evaluate(js)
    got = tt.evaluate(ts)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


def _bf16_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def test_bfloat16_features_and_encoder_match_jax(cora):
    """Under dtype="bfloat16" only the node features are bfloat16: h and
    every parameter stay float32 in both packages.  Features rounded to
    bfloat16 move the encoder output by ``gap`` against float32 ones; the
    port must agree with the JAX package far inside that gap, so a port that
    kept float32 features fails here."""
    kw = dict(KW, dtype="bfloat16")
    jt = JTrainer(JConfig(**kw), cora[0])
    tt = TTrainer(TConfig(**kw), cora[1], device="cpu")
    js = jt.init_state(0)
    ts = tt.init_state(0)
    params_from_jax(*jax.device_get((js.params, js.ema)), ts.encoder, ts.predictor)
    assert jt.x.dtype == jnp.bfloat16 and tt.x.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(tt.x), _bf16_bits(jt.x))
    assert all(p.dtype == torch.float32 for p in ts.encoder.parameters())
    jh = np.asarray(jt.encode(js.params, jt.g))
    th = tt.encode(ts)
    assert jh.dtype == np.float32 and th.dtype == torch.float32

    j32 = JTrainer(JConfig(**dict(kw, dtype="float32")), cora[0])
    scale = np.abs(jh).max()
    gap = np.abs(np.asarray(j32.encode(js.params, j32.g)) - jh).max() / scale
    tol = 1e-5  # float32 sums in another order
    assert gap > 10 * tol, gap
    np.testing.assert_allclose(th.numpy(), jh, rtol=tol, atol=tol * scale)

    # the xdp dropout divides bfloat16 features by keep in bfloat16, as
    # flax's Dropout does: entries both keep carry the same bits
    x = jt.x[:64]
    jout = nn.Dropout(0.25, deterministic=False).apply(
        {}, x, rngs={"dropout": jax.random.PRNGKey(0)})
    tout = tdropout(tt.x[:64], 0.25, True, torch.Generator().manual_seed(0))
    assert jout.dtype == jnp.bfloat16 and tout.dtype == torch.bfloat16
    both = (np.asarray(jout) != 0) & (tout != 0).numpy() & (np.asarray(x) != 0)
    assert both.sum() > 100
    np.testing.assert_array_equal(_bf16_bits(tout)[both], _bf16_bits(jout)[both])


def test_cli_collab_preset_at_the_bench_group_and_dtype(capsys):
    cfg = tcli.parseargs([
        "--dataset", "collab", "--predictor", "cn5", "--preset",
        "--frame_group", "8", "--dtype", "bfloat16", "--epochs", "1",
        "--runs", "1", "--synthetic_scale", "0.01", "--batch_size", "1024",
        "--linkbatchsize", "128", "--testbs", "1024", "--hiddim", "16",
        "--platform", "cpu"])
    assert (cfg.frame_group, cfg.dtype, cfg.k_small, cfg.ell_tables) == (
        8, "bfloat16", 16, True)
    summary = tcli.run(cfg)
    out = capsys.readouterr().out
    assert "Final result: val" in out and out.count("Hits@50  Run: 01") == 1
    assert 0.0 <= summary["val_mean"] <= 1.0


def test_cli_run_on_cpu(capsys):
    cfg = tcli.parseargs([
        "--dataset", "Cora", "--predictor", "cn5", "--model", "gcn",
        "--mplayers", "1", "--hiddim", "16", "--batch_size", "128",
        "--testbs", "256", "--epochs", "2", "--runs", "1", "--maskinput",
        "--pad_deg", "16", "--pad_deg2", "16", "--synthetic_scale", "0.1",
        "--ell_tables", "false", "--k_small", "0", "--platform", "cpu"])
    summary = tcli.run(cfg)
    out = capsys.readouterr().out
    assert "Final result: val" in out and out.count("Hits@50  Run: 01") == 2
    for key in ("val_mean", "tst_mean"):
        assert 0.0 <= summary[key] <= 1.0
    assert summary["headline"] == "Hits@100"


def test_zero_batch_epoch_warns():
    ds = tsynthetic("Cora", seed=1, scale=0.05)
    tr = TTrainer(TConfig(**{**KW, "batch_size": 1 << 20}), ds, device="cpu")
    state = tr.init_state(0)
    with pytest.warns(RuntimeWarning, match="ZERO batches"):
        _, loss = tr.train_epoch(state, np.random.default_rng(0), 1)
    assert loss == 0.0


def test_params_from_jax_rejects_unmapped(pair):
    _, _, tt, _, (params, ema) = pair
    state = tt.init_state(1)
    bad = {"encoder": params["encoder"],
           "predictor": {**params["predictor"], "Extra_0": {}}}
    with pytest.raises(KeyError, match="Extra_0"):
        params_from_jax(bad, ema, state.encoder, state.predictor)


@pytest.mark.filterwarnings("ignore:dataset 'Cora' unavailable offline")
@pytest.mark.parametrize("predictor,extra", [
    ("cn7", []), ("cn8", ["--hoist_frames"]), ("cn9", []),
    ("cn1", ["--hoist_frames"]), ("cn6", []),
])
def test_cli_runs_every_frame_predictor(capsys, predictor, extra):
    """The Cora README preset (for cn7 its OCNP command) for each new
    predictor, cut to a small graph, hoisted frames through the flag."""
    cfg = tcli.parseargs([
        "--dataset", "Cora", "--predictor", predictor, "--preset",
        "--epochs", "1", "--runs", "1", "--hiddim", "16", "--batch_size",
        "128", "--testbs", "512", "--synthetic_scale", "0.1", "--platform",
        "cpu", *extra])
    assert cfg.predictor == predictor and cfg.hoist_frames == bool(extra)
    if predictor == "cn7":
        assert (cfg.sum, cfg.model) == (0.0, "puregcn")
    summary = tcli.run(cfg)
    out = capsys.readouterr().out
    assert "Final result: val" in out and out.count("Hits@100  Run: 01") == 1
    assert 0.0 <= summary["val_mean"] <= 1.0

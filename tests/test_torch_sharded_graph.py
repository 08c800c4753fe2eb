"""Port parity: node-sharded training and eval
(ocn_tpu_torch/parallel/sharded_graph.py) on four gloo ranks on the CPU.

The ranks run once for the module (``ranks``, tests/torch_dist.py); the
JAX side (make_sharded_graph_train_step, the sharded Trainer) runs here on
conftest's eight virtual devices from the same NumPy inputs and initial
parameters.  As in tests/test_sharded_graph.py, every stochastic knob is
off and the frame caps sit above the graph's degrees where losses are
compared: the node-sharded step then equals the explicit DP step with the
same per-rank chunks (rtol 1e-5: the same sums in another order), and
JAX's sharded step (rtol 1e-4, Adam steps at lr 1e-3 over sums in another
order, as in tests/test_torch_trainer.py).  The dual-K split is held
against the single-device split trainer (rtol 5e-4, the JAX test's own)
and JAX's sharded epoch (rtol 1e-4); ELL tables on and off give the same
epoch (rtol 1e-6), and the sharded eval the replicated one's Hits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.config import Config as JConfig
from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.parallel import sharded_graph as JSG
from ocn_tpu.parallel.mesh import make_mesh
from ocn_tpu.train.loop import Trainer as JTrainer
from ocn_tpu_torch.config import Config as TConfig
from ocn_tpu_torch.config import require_supported
from ocn_tpu_torch.parallel import sharded_graph as TSG
from ocn_tpu_torch.parallel.launch import launch
import torch_dist as TD
from torch_parity import native_route, one_thread, trainer_pair  # noqa: F401 (autouse fixtures)

BASE = dict(dataset="Cora", predictor="cn5", model="puregcn", mplayers=2,
            hiddim=32, batch_size=256, testbs=256, maskinput=True, pad_deg=64,
            pad_deg2=64, linkbatchsize=32, two_hop_mode="gather", gnndp=0.0,
            xdp=0.0, tdp=0.0, gnnedp=0.0, predp=0.0, preedp=0.0,
            reorder="none", ell_tables=False, gnnlr=1e-3, prelr=1e-3)


def cfg(**kw):
    return dict(BASE, **kw)


def batches(tr, n=3):
    """tests/test_sharded_graph.py's _batch: (pos, neg, mask positions)."""
    ds = tr.ds
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        pos_all = np.asarray(ds.split_edge["train"]["edge"]).T
        idx = rng.permutation(pos_all.shape[1])[:tr.cfg.batch_size]
        neg = np.stack([rng.integers(0, ds.n_nodes, size=tr.cfg.batch_size),
                        rng.integers(0, ds.n_nodes, size=tr.cfg.batch_size)])
        out.append((pos_all[:, idx].astype(np.int64), neg,
                    np.maximum(tr.edge2pos[idx].reshape(-1), 0).astype(np.int64)))
    return out


@pytest.fixture(scope="module")
def setup():
    jds = jsynthetic("Cora", seed=0, scale=TD.CORA_SCALE)
    tds = TD.cora()
    probe = TD.trainer(cfg(), tds)[0]
    kmax, k2max = int(probe.g.deg.max()), int(probe.adj2.deg.max())
    exact = dict(pad_deg=kmax + 1, pad_deg2=k2max + 1)
    kws = {
        "plain": cfg(**exact),
        "cn6": cfg(predictor="cn6", **exact),
        "dualk": cfg(predictor="cn7", k_small=8, small_frac=0.5,
                     small_frac_neg=0.5, pad_deg=kmax + 1, pad_deg2=k2max + 1,
                     linkbatchsize=32, losstrick="auc_loss", ell_tables=True),
        "exact": cfg(pad_deg=kmax + 1, pad_deg2=k2max + 1, linkbatchsize=16),
        "prod": cfg(ell_tables=True, k_small=8, small_frac=0.5,
                    small_frac_neg=0.5, pad_deg=16, pad_deg2=32,
                    linkbatchsize=16),
    }
    init, jinit = {}, {}
    for name in ("plain", "cn6", "dualk", "exact"):
        jt, js, tt, ts = trainer_pair(kws[name], jds, tds)
        init[name], jinit[name] = TD.snapshot(ts), (jt, jax.device_get(js))
    return dict(jds=jds, tds=tds, kws=kws, init=init, jinit=jinit,
                batches=batches(probe), kmax=kmax)


@pytest.fixture(scope="module")
def ranks(setup):
    s, kws, init = setup, setup["kws"], setup["init"]
    node = dict(dp_devices=4, graph_sharding="node")
    nodes = np.random.default_rng(0).integers(0, s["tds"].n_nodes, size=4 * 16)
    cases = [
        ("gather", TD.gather_case, (kws["plain"], nodes, 8)),
        ("plain", TD.sharded_vs_spmd_case, (kws["plain"], init["plain"], s["batches"])),
        ("cn6", TD.sharded_vs_spmd_case, (kws["cn6"], init["cn6"], s["batches"])),
        ("dualk", TD.epoch_case, (dict(kws["dualk"], **node), init["dualk"])),
        ("ell_off", TD.epoch_case, (dict(kws["exact"], **node), init["exact"])),
        ("ell_on", TD.epoch_case, (dict(kws["exact"], ell_tables=True, **node),
                                   init["exact"], 0, True)),
        ("prod", TD.epoch_case, (dict(kws["prod"], **node), None)),
        ("scores", TD.sharded_scores_case,
         (dict(kws["cn6"], eval_sampling=False), init["cn6"],
          np.random.default_rng(5).integers(0, s["tds"].n_nodes, size=(2, 128)))),
    ]
    # citation2 has other features: both sides start from init_state(0)
    cases += [("eval_valid_edges", TD.sharded_eval_case,
               (eval_kw("valid_edges"), init["plain"], "valid_edges")),
              ("eval_citation2", TD.sharded_eval_case,
               (eval_kw("citation2"), None, "citation2"))]
    return launch(TD.run_cases, 4, cases, device="cpu", threads=1)


def eval_kw(data):
    """The eval comparisons' config: caps above every degree, chunk 16,
    citation2 with its randint-target negatives."""
    kw = cfg(pad_deg=128, pad_deg2=512, linkbatchsize=16, testbs=128,
             eval_sampling=False)
    if data == "citation2":
        kw.update(dataset="citation2", neg_mode="randint_target")
    else:
        kw.update(use_valedges_as_input=True)
    return kw


def test_sharded_gather_matches_replicated(ranks):
    for r in ranks:
        for key in ("ids", "w"):
            got, want = r["gather"][key]
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_host_partitions_and_routing_equal_jax(setup):
    """partition_windows, boundary_entry_layout, route_mask_positions,
    partition_ell and route_ell_mask: the same arrays as the JAX package's
    on the same graph and positions."""
    jt = setup["jinit"]["plain"][0]
    tt = TD.trainer(setup["kws"]["plain"], setup["tds"])[0]
    for got, want in zip(TSG.partition_windows(tt.g, 4), JSG.partition_windows(jt.g, 4)):
        np.testing.assert_array_equal(got, want)
    lay_t, lay_j = (TSG.boundary_entry_layout(tt.g, 4),
                    JSG.boundary_entry_layout(jt.g, 4))
    for key in lay_j:
        np.testing.assert_array_equal(lay_t[key], lay_j[key], err_msg=key)
    mp = setup["batches"][0][2]
    wpos0 = TSG.partition_windows(tt.g, 4)[4]
    for got, want in zip(
            TSG.route_mask_positions(lay_t, wpos0, mp, 4, 512, 7, 8, 9),
            JSG.route_mask_positions(lay_j, wpos0, mp, 4, 512, 7, 8, 9)):
        np.testing.assert_array_equal(got, want)
    tbl = np.arange(3 * 10).reshape(10, 3).astype(np.int32)
    np.testing.assert_array_equal(TSG.partition_ell(tbl, 4, 3),
                                  JSG.partition_ell(tbl, 4, 3))
    flat = np.array([0, 5, -1, 17, 29, 11])
    cleared = np.arange(6)
    for got, want in zip(TSG.route_ell_mask(flat, cleared, 4, 3, 3, 8),
                         JSG.route_ell_mask(flat, cleared, 4, 3, 3, 8)):
        np.testing.assert_array_equal(got, want)


def _jax_sharded_losses(setup, name):
    jt, js = setup["jinit"][name]
    step, prepare = JSG.make_sharded_graph_train_step(jt, make_mesh(4, 1))
    key = jax.random.PRNGKey(0)
    out = []
    for i, (pos, neg, mp) in enumerate(setup["batches"]):
        js, loss = step(js, jnp.asarray(pos.astype(np.int32)),
                        jnp.asarray(neg.astype(np.int32)),
                        prepare(mp.astype(np.int32)), jax.random.fold_in(key, i))
        out.append(float(loss))
    return out


@pytest.mark.parametrize("name", ["plain", "cn6"])
def test_sharded_step_matches_spmd_and_jax(setup, ranks, name):
    """Three steps: the node-sharded step against the port's explicit DP
    step with the same per-rank chunks (cn5; cn6's DP step takes the
    on-the-fly A^3, as in the JAX package, so it is held against JAX's
    sharded step only) and against make_sharded_graph_train_step."""
    want = _jax_sharded_losses(setup, name)
    for r in ranks:
        got = r[name]
        if name == "plain":
            np.testing.assert_allclose(got["sharded"], got["spmd"], rtol=1e-5)
        np.testing.assert_allclose(got["sharded"], want, rtol=1e-4)
    # the halo of the encoder's layers, the gathered h and scores, the
    # owner-gathered frames
    calls = ranks[0]["plain"]["comm"]["calls"]
    assert calls["all_to_all"] > 0 and calls["reduce_scatter"] > 0


def test_sharded_dual_k_matches_single_device_and_jax(setup, ranks):
    """cn7 (no EMA) with the dual-K split and ELL tables, pairing-sensitive
    auc loss: one sharded epoch against the single-device split trainer
    (the round-robin interleave puts every chunk, at its width, on some
    rank) and against JAX's sharded Trainer at dp 4."""
    kw = setup["kws"]["dualk"]
    tr1, st1 = TD.trainer(kw, setup["tds"], setup["init"]["dualk"])
    _, loss1 = tr1.train_epoch(st1, np.random.default_rng(0), 1)
    jt = JTrainer(JConfig(**kw, dp_devices=4, graph_sharding="node"), setup["jds"])
    assert jt._split == tr1._split is not None
    js = jt.init_state(0)
    _, jloss = jt.train_epoch(js, np.random.default_rng(0), 1)
    for r in ranks:
        got = r["dualk"]
        assert got["use_ell"] and tuple(got["split"]) == tuple(jt._split)
        np.testing.assert_allclose(got["loss"], loss1, rtol=5e-4)
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-4)


def test_sharded_ell_exactness(ranks):
    """With the caps above every degree the frozen tables are exact: the
    epoch with tables equals the one without (maskinput's ELL routing runs
    every batch)."""
    for r in ranks:
        assert r["ell_on"]["use_ell"] and not r["ell_off"]["use_ell"]
        np.testing.assert_allclose(r["ell_on"]["loss"], r["ell_off"]["loss"],
                                   rtol=1e-6)


def test_sharded_eval_matches_replicated(setup, ranks):
    """Sharded evaluate after a sharded epoch against the replicated
    evaluate of the same state, the replicated scorer at testbs equal to the
    chunk so the column sums see the same links."""
    kw = dict(setup["kws"]["exact"], ell_tables=True, testbs=16)
    got = ranks[0]["ell_on"]
    tr, state = TD.trainer(kw, setup["tds"], {"encoder": got["encoder"],
                                             "predictor": got["predictor"]})
    tr._refresh_ell(np.random.default_rng(1))  # offsets 0 at these caps
    want = tr.evaluate(state)
    for r in ranks:
        for key in want:
            np.testing.assert_allclose(r["ell_on"]["hits"][key], want[key],
                                       atol=1e-9, err_msg=key)


def test_sharded_encode_and_scores(setup, ranks):
    """cn6: the sharded encoder's h and the sharded scorer's scores against
    the replicated ones, chunk by chunk as each rank scores them."""
    kw = dict(setup["kws"]["cn6"], eval_sampling=False)
    tr, state = TD.trainer(kw, setup["tds"], setup["init"]["cn6"])
    h = tr.encode(state)
    edges = np.random.default_rng(5).integers(0, setup["tds"].n_nodes, size=(2, 128))
    c = tr._chunk()
    state.predictor.eval()
    with torch.no_grad():
        want = torch.cat([tr._score_chunk(
            state, h, tr.g, torch.as_tensor(edges[:, i:i + c]), torch.ones(c),
            None, False, tr.adj2, adj3=tr.adj3) for i in range(0, 128, c)])
    for r in ranks:
        np.testing.assert_allclose(r["scores"]["h"], h.numpy(), rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(r["scores"]["scores"], want.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_sharded_production_config_epoch(ranks):
    """ELL tables, the dual-K split and maskinput with caps that bind
    (capped rows, frozen windows): the epoch runs and its loss is finite."""
    for r in ranks:
        assert r["prod"]["use_ell"] and r["prod"]["split"] is not None
        assert np.isfinite(r["prod"]["loss"])


@pytest.mark.parametrize("field,value", [
    ("tp_devices", 2), ("predictor", "cn2"), ("two_hop_mode", "sddmm"),
    ("window_table", True), ("hoist_frames", True)])
def test_node_sharding_refuses_what_jax_refuses(field, value):
    kw = dict(dp_devices=2, graph_sharding="node", **{field: value})
    with pytest.raises(ValueError, match=f"Config.{field}"):
        require_supported(TConfig(**kw))
    # replicated (the mesh step) or on one device, the same values run
    require_supported(TConfig(**dict(kw, graph_sharding="replicated")))
    require_supported(TConfig(**dict(kw, dp_devices=1, tp_devices=1)))


@pytest.mark.parametrize("data", ["valid_edges", "citation2"])
def test_sharded_eval_full_graph_and_mrr(setup, ranks, data):
    """The sharded evaluate with use_valedges_as_input (the test split
    scored on the train+valid graph's shards) and the sharded evaluate_mrr
    on a tiny citation2, against the replicated evaluations of the same
    state, the replicated scorer at testbs equal to the chunk."""
    ds = TD.with_valid_edges(setup["tds"]) if data == "valid_edges" else TD.citation2()
    tr, state = TD.trainer(dict(eval_kw(data), testbs=16), ds,
                           setup["init"]["plain"] if data == "valid_edges" else None)
    assert int(tr.full_g.deg.max()) <= 128 and int(tr.adj2.deg.max()) <= 512
    if data == "citation2":
        want = tr.evaluate_mrr(state)
        assert want.keys() == {"valid", "test"}
    else:
        assert tr.full_g is not tr.g
        want = tr.evaluate(state)
    for r in ranks:
        got = r[f"eval_{data}"]
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=1e-9, err_msg=key)

"""Port parity: the accuracy instrument (ocn_tpu_torch/scripts/
accuracy_parity.py) against scripts/accuracy_parity.py.

* Every variant name on every graph of the study: the port's arm Config
  equals the one the JAX script builds (base_config, variant_overrides and
  its batch clamp), field by field, each graph's dataset loaded once at
  its arm's scale by each package.
* converge from the JAX initial state, dropouts 0, against the JAX script's
  epoch loop over the JAX Trainer: per-epoch losses at rtol 1e-4 and the
  same best Hits@K.  At sbm scale 0.25: at 0.1 the graph has 102 train
  edges, below the clamp's smallest batch of 256, so no batch would train.
* Dropout on: the first step's loss over many dropout draws on each side
  agrees in distribution (the packages draw other masks).
* The --against comparison on fixed records: means, sample sds and the
  two-sided Welch p against the Welch-Satterthwaite formula."""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
from scipy import stats

from ocn_tpu.data.loaders import loaddataset as jloaddataset
from ocn_tpu_torch.data.loaders import loaddataset as tloaddataset
from ocn_tpu_torch.scripts import accuracy_parity as T
from torch_parity import trainer_pair
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

_SPEC = importlib.util.spec_from_file_location(
    "jax_accuracy_parity",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts", "accuracy_parity.py"))
J = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(J)

# the graphs of the study at their arms' scales
SCALES = {"sbm": 1.0, "Cora": 1.0, "Citeseer": 1.0, "Pubmed": 0.5, "ppa": 0.005}
VARIANTS = ("exact", "capped", "capped_ell", "capped128_ell", "capped_k16",
            "exact_gather", "capped_sddmm", "rec8", "rec16", "capped_t32",
            "rec16_t32", "adj2cap256", "adj2cap1024", "hard16", "hard8",
            "lb256", "lb256_k16", "x3_exact", "x3_prod", "x3_noell",
            "x3_cap64", "x3_cap1024", "x3_k8", "x3_k32", "lb128", "lb128_k16")
EPOCHS = 24


def jax_arm_config(graph, variant, ds, epochs, predictor):
    """The Config of scripts/accuracy_parity.py run_one (:173-191)."""
    deg = np.bincount(np.asarray(ds.edge_index[0]), minlength=ds.n_nodes)
    cfg = J.base_config(graph, epochs, predictor)
    for k, v in J.variant_overrides(variant, int(deg.max())).items():
        setattr(cfg, k, v)
    e_train = int(np.asarray(ds.split_edge["train"]["edge"]).shape[0])
    if cfg.batch_size > e_train:
        cfg.batch_size = max(256, 1 << int(np.log2(e_train)))
        cfg.testbs = min(cfg.testbs, cfg.batch_size)
        cfg.linkbatchsize = min(cfg.linkbatchsize or cfg.batch_size,
                                cfg.batch_size)
    return cfg


@pytest.fixture(scope="module")
def datasets():
    """Each graph's dataset from each package, loaded on first use."""
    cache = {}

    def get(graph):
        if graph not in cache:
            kw = dict(seed=0, synthetic_scale=SCALES[graph])
            cache[graph] = (jloaddataset(graph, **kw), tloaddataset(graph, **kw))
        return cache[graph]

    return get


def test_variant_names():
    assert len(VARIANTS) == 26
    for name in VARIANTS:
        assert T.variant_overrides(name, 100) == J.variant_overrides(name, 100)
    with pytest.raises(KeyError):
        T.variant_overrides("capped_ell_x", 100)


@pytest.mark.parametrize("graph", list(SCALES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_arm_config_matches(datasets, graph, variant, monkeypatch):
    jds, tds = datasets(graph)
    want = jax_arm_config(graph, variant, jds, EPOCHS, "cn5")
    # the arm's own loaddataset call, answered from the module's datasets
    loads = []
    monkeypatch.setattr(T, "loaddataset", lambda *a, **kw: loads.append((a, kw)) or tds)
    ds, got = T.arm(graph, variant, 0, EPOCHS, "cn5", SCALES[graph])
    assert loads == [((graph,), dict(seed=0, synthetic_scale=SCALES[graph]))]
    assert (want.platform, got.platform) == ("cpu", "")
    want = dataclasses.replace(want, platform="")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ds.n_nodes == tds.n_nodes
    if got.reorder == "bfs":  # the relabelled graph, as JAX's run_one makes it
        np.testing.assert_array_equal(ds.edge_index,
                                      jds.reorder_bfs().edge_index)


CONVERGE_SCALE = 0.25
NO_DROPOUT = dict(gnndp=0.0, xdp=0.0, tdp=0.0, gnnedp=0.0, predp=0.0,
                  preedp=0.0)


@pytest.mark.parametrize("predictor", ["cn5", "cn7"])
def test_converge_matches_jax_loop(predictor):
    epochs, eval_every = 3, 1
    tds, cfg = T.arm("sbm", "capped_ell", 0, epochs, predictor, CONVERGE_SCALE)
    jds = jloaddataset("sbm", seed=0, synthetic_scale=CONVERGE_SCALE).reorder_bfs()
    kw = {**dataclasses.asdict(cfg), **NO_DROPOUT}
    jt, js, tt, ts = trainer_pair(kw, jds, tds)
    assert tt.cfg.batch_size < tt.train_edges.shape[1]  # a step an epoch

    # scripts/accuracy_parity.py:199-209 over the JAX Trainer
    rng = np.random.default_rng(0)
    jlosses, jbest = [], {}
    for epoch in range(1, epochs + 1):
        js, loss = jt.train_epoch(js, rng, epoch)
        jlosses.append(float(loss))
        if epoch % eval_every and epoch != epochs:
            continue
        for key, (trn, val, tst) in jt.evaluate(js).items():
            if key not in jbest or val > jbest[key][1]:
                jbest[key] = [trn, val, tst]

    losses, best = T.converge(tt, ts, np.random.default_rng(0), epochs,
                              eval_every)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert len(set(jlosses)) == epochs and np.isfinite(jlosses).all()
    assert best.keys() == jbest.keys()
    for key in jbest:
        np.testing.assert_allclose(best[key], jbest[key], rtol=1e-4, err_msg=key)


def test_dropout_distribution_matches_jax():
    """Dropout on, as the arms train: the Citeseer preset (x, layer, tail,
    edge and predictor dropouts) from the JAX initial state.  The packages
    draw other masks, so they agree in distribution only, over 32 draws on
    each side: the encoder's train-mode h element by element (the squared
    z of the two means averages near 1, the summed variances within 10 %),
    and the first step's loss on one batch (means within 4 standard
    errors)."""
    import copy

    import jax
    import torch

    from ocn_tpu_torch.sparse import build as B

    n = 32
    tds, cfg = T.arm("Citeseer", "capped_ell", 0, 1, "cn5", 0.25)
    jds = jloaddataset("Citeseer", seed=0, synthetic_scale=0.25).reorder_bfs()
    assert min(cfg.xdp, cfg.tdp, cfg.gnndp, cfg.gnnedp, cfg.predp) > 0
    jt, js, tt, ts = trainer_pair(dataclasses.asdict(cfg), jds, tds)

    encode = jax.jit(lambda p, key: jt.encoder.apply(
        {"params": p}, jt.x, jt.g, True, rngs={"dropout": key}))
    ts.encoder.train()
    with torch.no_grad():
        th = np.stack([ts.encoder(tt.x, tt.g, torch.Generator().manual_seed(i)).numpy()
                       for i in range(n)])
    jh = np.stack([np.asarray(encode(js.params["encoder"], jax.random.PRNGKey(i)))
                   for i in range(n)])
    vj, vt = jh.var(0, ddof=1), th.var(0, ddof=1)
    assert (vj > 0).mean() > 0.5 and ((vj > 0) == (vt > 0)).all()
    live = vj + vt > 0
    z2 = (th.mean(0) - jh.mean(0))[live] ** 2 / ((vj + vt)[live] / n)
    assert 0.9 < z2.mean() < 1.2, z2.mean()
    assert abs(vt.sum() / vj.sum() - 1) < 0.1, vt.sum() / vj.sum()

    rng = np.random.default_rng(5)
    e = tt.train_edges.shape[1]
    idx = rng.permutation(e)[:cfg.batch_size]
    neg = B.negative_sampling(tt.ds.edge_index, tt.ds.n_nodes, e, rng)
    pos_b, neg_b = tt.train_edges[:, idx], neg[:, idx]
    jin = jt.prepare_batch(pos_b, neg_b, idx)
    tin = tt.prepare_batch(pos_b, neg_b, idx)
    jl, tl = [], []
    for i in range(n):
        # the JAX step donates its state: each draw steps a copy
        _, loss = jt.train_step(jax.tree_util.tree_map(lambda x: x.copy(), js),
                                *jin[:3], jax.random.PRNGKey(1000 + i), *jin[3:])
        jl.append(float(loss))
        with torch.no_grad():
            tl.append(float(tt.step_loss(copy.deepcopy(ts), *tin[:3],
                                         torch.Generator().manual_seed(1000 + i),
                                         *tin[3:])))
    jl, tl = np.array(jl), np.array(tl)
    assert len(set(jl)) == n and len(set(tl)) == n  # the masks differ by draw
    se = np.sqrt(jl.var(ddof=1) / n + tl.var(ddof=1) / n)
    assert abs(tl.mean() - jl.mean()) < 4 * se


def _record(graph, variant, run, h20, h50, h100, predictor="cn5"):
    return {"graph": graph, "variant": variant, "run": run,
            "predictor": predictor,
            "best": {"Hits@20": [0, 0, h20], "Hits@50": [0, 0, h50],
                     "Hits@100": [0, 0, h100]}}


def test_against_rows(tmp_path, capsys):
    ref_h50, port_h50 = [0.1, 0.2, 0.3], [0.4, 0.5, 0.6, 0.7]
    ref = [_record("sbm", "capped_ell", i, 0.05, h, 0.5)
           for i, h in enumerate(ref_h50)]
    ref.append(_record("Cora", "capped_ell", 0, 0.1, 0.1, 0.1))  # no port run
    port = [_record("sbm", "capped_ell", i, 0.05 + 0.01 * i, h, 0.5 + 0.1 * i)
            for i, h in enumerate(port_h50)]
    rows = T.compare(ref, port)
    assert [r["arm"] for r in rows] == [("sbm", "cn5", "capped_ell")]
    h = rows[0]["Hits@50"]
    assert h["ref"] == (3, pytest.approx(0.2), pytest.approx(0.1))
    assert h["port"] == (4, pytest.approx(0.55), pytest.approx(np.std(port_h50, ddof=1)))
    assert h["diff"] == pytest.approx(0.35)
    # Welch: t over the per-side standard errors, Welch-Satterthwaite df
    va, vb = 0.01 / 3, np.var(port_h50, ddof=1) / 4
    t = 0.35 / np.sqrt(va + vb)
    df = (va + vb) ** 2 / (va ** 2 / 2 + vb ** 2 / 3)
    assert h["p"] == pytest.approx(2 * stats.t.sf(t, df), rel=1e-9)
    assert h["p"] == pytest.approx(0.0100769, abs=1e-7)  # just passes 0.01
    # Hits@20: a reference without spread against a port with some
    h20 = rows[0]["Hits@20"]
    assert h20["diff"] == pytest.approx(0.015)
    assert h20["p"] == pytest.approx(0.1027281, abs=1e-7)

    # the --table --against output: one comparison row for the shared arm
    for name, recs in (("ref", ref), ("port", port)):
        (tmp_path / f"{name}.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in recs))
    T.main(["--table", "--out", str(tmp_path / "port.jsonl"),
            "--against", str(tmp_path / "ref.jsonl")])
    out = capsys.readouterr().out.splitlines()
    row = [line for line in out if line.startswith("| sbm | cn5 | capped_ell | 3 ")]
    assert len(row) == 1
    assert "| 0.2000±0.1000 | 4 | 0.5500±0.1291 | +0.3500 | 0.0101 | 0.103 |" in row[0]


def test_defaults_to_the_card(tmp_path):
    """Without --platform cpu the instrument runs on the card, and raises
    before it loads anything when there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default-device run is valid here")
    out = tmp_path / "p.jsonl"
    argv = ["--graph", "sbm", "--variants", "capped_ell", "--runs", "1",
            "--epochs", "1", "--scale", "0.25", "--out", str(out)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_one("sbm", "capped_ell", 0, 1, 1, scale=0.25)
    assert not out.exists()
    T.main(argv + ["--platform", "cpu"])
    rec = json.loads(out.read_text())
    assert (rec["device"], rec["power_limit"], rec["membership_launches"]) == ("cpu", None, 0)
    T.main(argv + ["--platform", "cpu"])  # resumes: the pair is done
    assert len(out.read_text().splitlines()) == 1

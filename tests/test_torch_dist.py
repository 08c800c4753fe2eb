"""Port parity: the multi-device tier on gloo ranks on the CPU
(ocn_tpu_torch/parallel/: launch, mesh, node_sharded, spmd, shard; the
Trainer's mesh step; graft_entry; cli.run over ranks).

The ranks are spawned once for the module (``ranks``: four gloo ranks on
the CPU running every case of tests/torch_dist.py), with no JAX in them;
the JAX side runs here on conftest's eight virtual devices, from the same
NumPy inputs and the same initial parameters (weights.params_from_jax).
Dropout is 0 and the frame caps sit above the graph's degrees in the
step comparisons, so no random stream is read.  Tolerances: rtol 1e-4
against JAX over Adam steps at lr 1e-3 (sums in another order on each
side, compounded by Adam, as in tests/test_torch_trainer.py); 1e-5 between
the port's mesh step and its single-device step (the same sums, split over
ranks), with atol 1e-5 on parameters after Adam steps (an entry whose
gradient is float noise around 0 moves by up to lr either way); 1e-5 for
the SpMMs against the dense product."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu.config import Config as JConfig
from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu.train.loop import Trainer as JTrainer
from ocn_tpu_torch.parallel.launch import backend_for, launch
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.weights import params_from_jax, tp_join
import torch_dist as TD
from torch_parity import native_route, one_thread, trainer_pair  # noqa: F401 (autouse fixtures)

KW = dict(dataset="Cora", predictor="cn5", model="puregcn", mplayers=2,
          hiddim=32, batch_size=128, testbs=128, maskinput=True, pad_deg=64,
          pad_deg2=256, linkbatchsize=32, gnndp=0.0, xdp=0.0, tdp=0.0,
          gnnedp=0.0, predp=0.0, preedp=0.0, gnnlr=1e-3, prelr=1e-3,
          ell_tables=False, k_small=0)
SPMM_SEEDS = {"dense": (0, 64, 0.12), "ring": (1, 60, 0.15),
              "boundary": (2, 72, 0.10)}  # tests/test_dist.py's graphs


def spmm_inputs(kind):
    from tests.test_frame import random_graph

    seed, n, p = SPMM_SEEDS[kind]
    rng = np.random.default_rng(seed)
    g, dense = random_graph(rng, n=n, p=p)
    ip = np.asarray(g.indptr)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    ct = rng.standard_normal((n, 8)).astype(np.float32)
    return g, dense, (ip, np.asarray(g.col)[:int(ip[-1])], n), x, ct


@pytest.fixture(scope="module")
def setup():
    """The JAX trainer and state, the port's initial state dicts loaded
    from it, and the batches: (pos, neg, idx) and (pos, neg, mask
    positions)."""
    jds = jsynthetic("Cora", seed=0, scale=TD.CORA_SCALE)
    tds = TD.cora()
    jt, js, tt, ts = trainer_pair(KW, jds, tds)
    assert int(tt.g.deg.max()) <= KW["pad_deg"]
    assert int(tt.adj2.deg.max()) <= KW["pad_deg2"]
    e = tt.train_edges.shape[1]
    rng = np.random.default_rng(5)
    perm = rng.permutation(e)
    neg = B.negative_sampling(tds.edge_index, tds.n_nodes, e, rng)
    bs = KW["batch_size"]
    idx_batches = [(tt.train_edges[:, perm[i * bs:(i + 1) * bs]],
                    neg[:, perm[i * bs:(i + 1) * bs]], perm[i * bs:(i + 1) * bs])
                   for i in range(2)]
    mp_batches = [(p, n, np.maximum(tt.edge2pos[i].reshape(-1), 0))
                  for p, n, i in idx_batches]
    init = TD.snapshot(ts)
    return dict(jt=jt, js=jax.device_get(js), tt=tt, ts=ts, init=init,
                idx_batches=idx_batches, mp_batches=mp_batches)


@pytest.fixture(scope="module")
def ranks(setup):
    s = setup
    cases = [("layout", TD.mesh_layout, ())]
    cases += [(f"spmm_{k}", TD.spmm_case, (k,) + spmm_inputs(k)[2:])
              for k in SPMM_SEEDS]
    cases += [("spmd", TD.spmd_case, (KW, s["init"], s["mp_batches"])),
              ("mesh", TD.mesh_step_case,
               (dict(KW, dp_devices=2, tp_devices=2), s["init"], s["idx_batches"]))]
    return launch(TD.run_cases, 4, cases, device="cpu", threads=1)


def test_backend_rule_and_mesh_layout(ranks):
    # ranks that share a card, or run on the CPU, talk over gloo
    assert backend_for(4, "cpu") == "gloo"
    assert backend_for(torch.cuda.device_count() + 1, "cuda") == "gloo"
    assert [r["layout"]["backend"] for r in ranks] == ["gloo"] * 4
    # rank r sits at (r // tp, r % tp), as np.reshape(devices, (dp, tp))
    assert [(r["layout"]["dp_rank"], r["layout"]["tp_rank"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("kind", ["dense", "boundary"])
def test_partitions_equal_jax(kind):
    from ocn_tpu.parallel import node_sharded as JNS
    from ocn_tpu_torch.parallel import node_sharded as TNS
    from ocn_tpu_torch.sparse.csr import graph_from_numpy

    g, _, host, _, _ = spmm_inputs(kind)
    tg = graph_from_numpy(*host)
    if kind == "dense":
        want, got = JNS.partition_graph(g, 4), TNS.partition_graph(tg, 4)
    else:
        want, got = JNS.partition_graph_boundary(g, 4), TNS.partition_graph_boundary(tg, 4)
    for field, value in vars(want).items():
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(value), err_msg=field)


@pytest.mark.parametrize("kind", list(SPMM_SEEDS))
def test_spmm_matches_dense_and_jax(ranks, kind):
    """Forward rows against A @ x and JAX's SpMM; the backward
    (d sum(out * ct) / dx) against A^T ct and JAX's gradient."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ocn_tpu.parallel import node_sharded as JNS
    from ocn_tpu.parallel.mesh import make_mesh

    g, dense, _, x, ct = spmm_inputs(kind)
    n = x.shape[0]
    out = np.concatenate([r[f"spmm_{kind}"]["out"] for r in ranks])[:n]
    grad = np.concatenate([r[f"spmm_{kind}"]["grad"] for r in ranks])[:n]
    np.testing.assert_allclose(out, dense @ x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, dense.T @ ct, rtol=1e-5, atol=1e-5)

    mesh = make_mesh(dp=4, tp=1)
    if kind == "boundary":
        fn, rows = JNS.make_boundary_spmm(mesh, JNS.partition_graph_boundary(g, 4))
    else:
        make = JNS.make_ring_spmm if kind == "ring" else JNS.make_node_sharded_spmm
        fn, rows = make(mesh, JNS.partition_graph(g, 4))
    xp = np.zeros((rows, 8), np.float32)
    xp[:n] = x
    ctp = np.zeros_like(xp)
    ctp[:n] = ct
    xs = jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P("dp", None)))
    jgrad = jax.grad(lambda v: jnp.sum(fn(v) * ctp))(xs)
    np.testing.assert_allclose(out, np.asarray(fn(xs))[:n], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, np.asarray(jgrad)[:n], rtol=1e-5, atol=1e-5)
    # the exchange of each: forward and backward (the dense all-gather's
    # backward is a reduce-scatter; the ring shifts dp - 1 times each way)
    calls = ranks[0][f"spmm_{kind}"]["calls"]
    want = {"dense": {"all_gather": 1, "reduce_scatter": 1},
            "ring": {"ring": 6}, "boundary": {"all_to_all": 2}}[kind]
    assert calls == want


def test_spmd_step_matches_jax(setup, ranks):
    """The explicit DP step at dp 4 against make_spmd_train_step: the
    losses and the parameters after the steps (rtol 1e-4)."""
    from ocn_tpu.parallel.mesh import make_mesh
    from ocn_tpu.parallel.spmd import make_spmd_train_step

    jt = setup["jt"]
    step = make_spmd_train_step(jt, make_mesh(dp=4, tp=1))
    js = jax.device_get(jt.init_state(0))
    losses = []
    for i, (pos, neg, mp) in enumerate(setup["mp_batches"]):
        js, loss = step(js, jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mp),
                        jax.random.PRNGKey(i))
        losses.append(float(loss))
    got = [r["spmd"] for r in ranks]
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
    enc, pred = copy.deepcopy(setup["ts"].encoder), copy.deepcopy(setup["ts"].predictor)
    js = jax.device_get(js)
    params_from_jax(js.params, js.ema, enc, pred)
    for name, t in enc.state_dict().items():
        np.testing.assert_allclose(got[0]["encoder"][name], t, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    for name, t in pred.state_dict().items():
        np.testing.assert_allclose(got[0]["predictor"][name], t, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_mesh_step_equals_single_device_and_jax(setup, ranks):
    """dp 2 x tp 2: the losses of two steps equal the port's single-device
    step's (rtol 1e-5) and JAX's Trainer(dp 2, tp 2)'s (rtol 1e-4); the tp
    shards of the final predictor join to the single-device parameters;
    the eval after them equals the single-device eval."""
    tt = setup["tt"]
    single_tr, single = TD.trainer(KW, tt.ds, setup["init"])
    single_losses = TD.steps(single_tr, single, setup["idx_batches"])
    jt = JTrainer(JConfig(**KW, dp_devices=2, tp_devices=2),
                  jsynthetic("Cora", seed=0, scale=TD.CORA_SCALE))
    js = jt.init_state(0)
    jl = []
    for i, (pos, neg, idx) in enumerate(setup["idx_batches"]):
        pe, ne, mp, ip, inn = jt.prepare_batch(pos, neg, idx)
        js, loss = jt.train_step(js, pe, ne, mp, jax.random.PRNGKey(i), ip, inn)
        jl.append(float(loss))
    mesh = [r["mesh"] for r in ranks]
    for r in mesh:
        np.testing.assert_allclose(r["losses"], single_losses, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-4)
    # the first Dense of each MLP that reads h ran row-parallel
    names = set(mesh[0]["names"])
    assert names == {"xijlin.dense.0.weight", "xcn1lin.dense.0.weight",
                     "xcn2lin.dense.0.weight"}
    shards = sorted(mesh[:2], key=lambda r: r["tp_rank"])
    assert shards[0]["predictor_shard"]["xijlin.dense.0.weight"].shape[1] == 16
    joined = tp_join([r["predictor_shard"] for r in shards], names)
    for name, t in single.predictor.state_dict().items():
        np.testing.assert_allclose(joined[name], t, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for name, t in single.encoder.state_dict().items():
        np.testing.assert_allclose(mesh[0]["encoder"][name], t, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    want = single_tr.evaluate(single)
    for r in mesh:
        for key in want:
            np.testing.assert_allclose(r["hits"][key], want[key], rtol=1e-6)


def test_graft_entry_and_multichip_dry_run(capsys):
    """graft_entry: entry()'s forward, and dryrun_multichip(4): the mesh
    step (dp 2 x tp 2) and the node-sharded production set over four
    ranks, every rank with the same finite losses."""
    from ocn_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (256,) and torch.isfinite(out).all()
    runs = graft_entry.dryrun_multichip(4, device="cpu")
    assert [(r["dp"], r["tp"], r["backend"]) for r in runs] == [(2, 2, "gloo")] * 4
    assert len({r["loss"] for r in runs}) == 1
    assert len({r["sharded_loss"] for r in runs}) == 1
    assert "dryrun_multichip ok" in capsys.readouterr().out


def test_cli_runs_node_sharded_ranks(tmp_path, monkeypatch, capfd):
    """cli.run with --dp_devices 2 --graph_sharding node --platform cpu:
    two ranks train and evaluate; rank 0 alone prints and logs."""
    from ocn_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    cfg = cli.parseargs([
        "--dataset", "Cora", "--predictor", "cn5", "--model", "puregcn",
        "--mplayers", "1", "--hiddim", "16", "--batch_size", "128",
        "--linkbatchsize", "32", "--testbs", "128", "--epochs", "2",
        "--runs", "1", "--maskinput", "--pad_deg", "16", "--pad_deg2", "16",
        "--synthetic_scale", "0.2", "--ell_tables", "--dp_devices", "2",
        "--graph_sharding", "node", "--platform", "cpu"])
    summary = cli.run(cfg)
    assert summary["headline"] == "Hits@100"
    assert all(np.isfinite(summary[k]) for k in ("val_mean", "tst_mean"))
    out = capfd.readouterr().out  # the ranks' own stdout
    assert out.count("Final result") == 1 and out.count("trn time") == 2
    # one metrics file, two epochs' records of each Hits key
    lines = (tmp_path / "rec" / "puregcn_cn5" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 + 2 * 3


def test_a_failed_rank_fails_the_launch():
    """A rank that raises fails the launch at once: its peers, waiting for
    it in a collective, are terminated and the error reaches the caller
    (the first rank to fail: the one that raised, or its peer whose
    collective lost the connection)."""
    import time

    from torch.multiprocessing import ProcessRaisedException

    t0 = time.perf_counter()
    with pytest.raises(ProcessRaisedException,
                       match="terminated with the following error"):
        launch(TD.fail_on, 2, 1, device="cpu", timeout_s=60)
    assert time.perf_counter() - t0 < 60

"""Rank bodies of the multi-device parity tests (tests/test_torch_dist.py,
tests/test_torch_sharded_graph.py).  Not a test file.  The ranks are
spawned processes (ocn_tpu_torch.parallel.launch), so this module imports
torch, NumPy and ocn_tpu_torch only, never JAX: the JAX side of each
comparison runs in the pytest process, and the two meet as NumPy arrays and
state dicts.  Every rank runs torch with one intra-op thread (as
torch_parity.one_thread does for the pytest process): six test workers of
four ranks each share eight cores."""
import numpy as np
import torch

from ocn_tpu_torch.config import Config
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.parallel.mesh import make_mesh
from ocn_tpu_torch.train.loop import Trainer

# the JAX multi-device tests' graph (tests/test_sharded_graph.py)
CORA_SCALE = 0.2


def cora():
    return synthetic_dataset("Cora", seed=0, scale=CORA_SCALE)


def trainer(kw: dict, ds, init=None) -> tuple:
    """A CPU Trainer on Config(**kw) and its state, the modules loaded from
    ``init`` ({"encoder": state_dict, "predictor": state_dict}) when
    given."""
    tr = Trainer(Config(**kw), ds, device="cpu")
    state = tr.init_state(0)
    if init is not None:
        state.encoder.load_state_dict(init["encoder"])
        state.predictor.load_state_dict(init["predictor"])
    return tr, state


def snapshot(state) -> dict:
    return {"encoder": {k: v.detach().clone() for k, v in
                        state.encoder.state_dict().items()},
            "predictor": {k: v.detach().clone() for k, v in
                          state.predictor.state_dict().items()}}


def steps(tr, state, batches, gen=None):
    """Trainer.train_step over ``batches`` of (pos, neg, idx) host arrays;
    returns the losses."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    losses = []
    for pos, neg, idx in batches:
        pe, ne, mp, ip, inn = tr.prepare_batch(pos, neg, idx)
        state, loss = tr.train_step(state, pe, ne, mp, gen, ip, inn)
        losses.append(float(loss))
    return losses


def run_cases(info, cases):
    """Each case is (name, function, args): function(info, *args) on this
    rank, one intra-op thread; returns {name: result}."""
    torch.set_num_threads(1)
    return {name: fn(info, *args) for name, fn, args in cases}


# ---------------------------------------------------------------- mesh
def mesh_layout(info):
    m = make_mesh(2, 2, info.device)
    return {"dp_rank": m.dp_rank, "tp_rank": m.tp_rank, "backend": info.backend}


def spmm_case(info, kind, graph, x, ct):
    """Rank d's rows of A @ x and of d(sum(out * ct))/dx through one of the
    node-sharded SpMMs (parallel/node_sharded.py) at dp 4; ``graph`` is
    (indptr, col, n) host CSR."""
    from ocn_tpu_torch.parallel import node_sharded as NS
    from ocn_tpu_torch.sparse.csr import graph_from_numpy

    g = graph_from_numpy(*graph)
    mesh = make_mesh(4, 1, info.device)
    if kind == "boundary":
        part = NS.partition_graph_boundary(g, 4)
        fn, rows = NS.make_boundary_spmm(mesh, part)
    else:
        part = NS.partition_graph(g, 4)
        make = NS.make_ring_spmm if kind == "ring" else NS.make_node_sharded_spmm
        fn, rows = make(mesh, part)
    rp = part.rows_per
    xp = np.zeros((rows, x.shape[1]), np.float32)
    xp[:x.shape[0]] = x
    ctp = np.zeros_like(xp)
    ctp[:x.shape[0]] = ct
    me = mesh.dp_rank
    xl = torch.as_tensor(xp[me * rp:(me + 1) * rp]).requires_grad_()
    out = fn(xl)
    (out * torch.as_tensor(ctp[me * rp:(me + 1) * rp])).sum().backward()
    return {"rows": (me * rp, (me + 1) * rp), "out": out.detach().numpy(),
            "grad": xl.grad.numpy(), "calls": dict(mesh.comm.calls)}


def spmd_case(info, kw, init, batches):
    """The explicit DP step at dp 4 (parallel/spmd.py) from ``init``:
    losses and the final state."""
    from ocn_tpu_torch.parallel.spmd import make_spmd_train_step

    tr, state = trainer(kw, cora(), init)
    step = make_spmd_train_step(tr, make_mesh(4, 1, info.device))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for pos, neg, mp in batches:
        state, loss = step(state, torch.as_tensor(pos), torch.as_tensor(neg),
                           torch.as_tensor(mp), gen)
        losses.append(float(loss))
    return {"losses": losses, **snapshot(state)}


def mesh_step_case(info, kw, init, batches):
    """The dp x tp mesh step from ``init``: losses, this rank's tp shard of
    the final predictor state (weights.tp_shard) and the row-parallel
    names."""
    from ocn_tpu_torch.weights import tp_shard

    tr, state = trainer(kw, cora(), init)
    losses = steps(tr, state, batches)
    names = tr.row_parallel_names(state)
    full = snapshot(state)
    return {"losses": losses, "names": sorted(names), "tp_rank": tr.mesh.tp_rank,
            "predictor_shard": tp_shard(full["predictor"], names,
                                        tr.mesh.tp_rank, tr.mesh.tp),
            "encoder": full["encoder"], "hits": tr.evaluate(state)}


# ---------------------------------------------------------- node-sharded
def sharded_vs_spmd_case(info, kw, init, batches):
    """The node-sharded step and the explicit DP step at dp 4 from the same
    state, on the same batches of host (pos, neg, mask positions)."""
    from ocn_tpu_torch.parallel.spmd import make_spmd_train_step

    ds = cora()
    tr_r, st_r = trainer(kw, ds, init)
    step_r = make_spmd_train_step(tr_r, make_mesh(4, 1, info.device))
    tr_s, st_s = trainer(dict(kw, dp_devices=4, graph_sharding="node"), ds, init)
    g_r, g_s = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    out = {"spmd": [], "sharded": []}
    for pos, neg, mp in batches:
        st_r, l_r = step_r(st_r, torch.as_tensor(pos), torch.as_tensor(neg),
                           torch.as_tensor(mp), g_r)
        pe, ne, _, ip, inn = tr_s.prepare_batch(pos, neg, None)
        st_s, l_s = tr_s.train_step(st_s, pe, ne, mp, g_s, ip, inn)
        out["spmd"].append(float(l_r))
        out["sharded"].append(float(l_s))
    out["comm"] = tr_s.mesh.comm.record()
    return out


def epoch_case(info, kw, init, seed=0, evaluate=False):
    """One train_epoch of the Trainer on Config(**kw) from ``init``: its
    loss, whether the tables and the split are on, and with ``evaluate``
    the Hits@K of an evaluate after it and the final state."""
    tr, state = trainer(kw, cora(), init)
    state, loss = tr.train_epoch(state, np.random.default_rng(seed), 1)
    out = {"loss": loss, "use_ell": bool(tr._use_ell), "split": tr._split}
    if evaluate:
        out["hits"] = tr.evaluate(state)
        out.update(snapshot(state))
    return out


def sharded_scores_case(info, kw, init, edges):
    """Sharded encode and score of (2, bs) edges (valid everywhere) at dp 4
    from ``init``, eval mode; with the replicated h for comparison."""
    tr, state = trainer(dict(kw, dp_devices=4, graph_sharding="node"), cora(), init)
    h = tr.encode(state)
    return {"h": h.numpy(),
            "scores": tr._sharded_eval().scores(state, h, edges.T)}



def gather_case(info, kw, nodes, k):
    """sharded_gather_neighbors at dp 4 against gather_neighbors on the
    whole graph, for this rank's slice of ``nodes`` (no sampling)."""
    from ocn_tpu_torch.ops.frame import gather_neighbors

    tr, _ = trainer(dict(kw, dp_devices=4, graph_sharding="node"), cora())
    lw = tr._sharded_train().sh.windows(0)
    b = nodes.shape[0] // 4
    mine = torch.as_tensor(nodes[info.rank * b:(info.rank + 1) * b])
    got = gather_neighbors(lw, mine, k)
    want = gather_neighbors(tr.g, mine, k)
    return {"ids": (got.ids.numpy(), want.ids.numpy()),
            "w": (got.w.numpy(), want.w.numpy())}


def fail_on(info, rank):
    """Rank ``rank`` raises; the others wait for it in a collective."""
    import torch.distributed as dist

    if info.rank == rank:
        raise ValueError(f"rank {rank} fails")
    dist.barrier()


def with_valid_edges(ds):
    """The dataset with its train+valid graph (use_valedges_as_input)."""
    import dataclasses

    from ocn_tpu_torch.sparse import build as B

    full = np.concatenate([ds.edge_index, ds.split_edge["valid"]["edge"].T], 1)
    return dataclasses.replace(
        ds, full_edge_index=B.symmetrize_edge_index(full, ds.n_nodes))


def citation2():
    """A tiny synthetic citation2 (MRR eval), cut as chip_smoke's reference
    cut it: 640 train links, 32 valid and test sources."""
    import dataclasses

    ds = synthetic_dataset("citation2", seed=0, scale=0.00015)
    split = {part: {k: v[:640 if part == "train" else 32] for k, v in d.items()}
             for part, d in ds.split_edge.items()}
    return dataclasses.replace(ds, split_edge=split).reorder_bfs()


def sharded_eval_case(info, kw, init, data):
    """The node-sharded evaluate (Hits@K, with use_valedges_as_input the
    train+valid graph's shards for the test split) or evaluate_mrr of the
    state ``init`` at dp 4."""
    ds = with_valid_edges(cora()) if data == "valid_edges" else citation2()
    tr, state = trainer(dict(kw, dp_devices=4, graph_sharding="node"), ds, init)
    return tr.evaluate_mrr(state) if data == "citation2" else tr.evaluate(state)


def mesh_vs_single_case(info, kw, dp, tp):
    """Two steps and an evaluate of the Trainer on Config(**kw) as a
    dp x tp mesh, from init_state(0), on batches drawn as the
    single-device side draws them (mesh_batches); the losses and Hits."""
    tr, state = trainer(dict(kw, dp_devices=dp, tp_devices=tp), cora())
    if tr._use_ell:
        tr._refresh_ell(np.random.default_rng(7))
    losses = steps(tr, state, mesh_batches(tr))
    return {"losses": losses, "hits": tr.evaluate(state)}


def mesh_batches(tr, n=2):
    """n batches of (pos, neg, idx) from one NumPy seed."""
    from ocn_tpu_torch.sparse import build as B

    e = tr.train_edges.shape[1]
    rng = np.random.default_rng(5)
    perm = rng.permutation(e)
    neg = B.negative_sampling(tr.ds.edge_index, tr.ds.n_nodes, e, rng)
    bs = tr.cfg.batch_size
    return [(tr.train_edges[:, perm[i * bs:(i + 1) * bs]],
             neg[:, perm[i * bs:(i + 1) * bs]], perm[i * bs:(i + 1) * bs])
            for i in range(n)]


# ------------------------------------------------------ weak-scaling harness
def scaling_case(info, dp, per_dev, overrides, init):
    """The first step's loss of each mode of ocn_tpu_torch/scripts/
    bench_scaling.py at ``dp`` ranks: the script's Config with
    ``overrides``, its inputs and its step (make_step), from ``init`` ({mode:
    state dicts})."""
    import dataclasses

    from ocn_tpu_torch.scripts import bench_scaling as S

    torch.set_num_threads(1)
    ds = S.scaling_dataset()
    out = {}
    for mode in S.MODES:
        cfg = dataclasses.replace(S.scaling_config(mode, dp, per_dev), **overrides)
        tr = Trainer(cfg, ds, device="cpu")
        step = S.make_step(tr, mode, dp, tr.device,
                           *S.scaling_inputs(ds, cfg.batch_size, tr.edge2pos))
        state = tr.init_state(0)
        state.encoder.load_state_dict(init[mode]["encoder"])
        state.predictor.load_state_dict(init[mode]["predictor"])
        out[mode] = float(step(state, torch.Generator().manual_seed(0))[1])
    return out

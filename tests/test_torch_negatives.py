"""The epoch's uniform negatives drawn from the train CSR (ops/negatives.py):
the kernel's plain version against the native host sampler, bit for bit,
at several sizes and seeds, on dense graphs that take more than one round
of candidates and on graphs whose candidates run out; the trainer's draw
from its graph (the route a card takes) against ``B.negative_sampling``,
links and stream; and a CPU epoch, which keeps the host sampler, against
the parent's derivation of its batches, permutation and generator seed.
The kernel itself is held to the same samplers in tests/test_torch_cuda.py.
"""
import types

import numpy as np
import pytest
import torch

from ocn_tpu_torch.config import Config
from ocn_tpu_torch.data.loaders import synthetic_dataset
from ocn_tpu_torch.ops import negatives as N
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.train.loop import Trainer
from ocn_tpu_torch.utils import native
from torch_parity import one_thread  # noqa: F401 (autouse: one intra-op thread)


def _dense(n, removed):
    """Both directions of the complete graph on n nodes without the
    undirected pairs (u, u + 1) for u < removed."""
    gone = {(u, u + 1) for u in range(removed)}
    pairs = [(u, v) for u in range(n) for v in range(n)
             if u != v and (min(u, v), max(u, v)) not in gone]
    return np.array(pairs, np.int64).T


# name: (edge_index, n); every edge list holds both directions
GRAPHS = {
    "cora_bfs": lambda: (lambda d: (d.edge_index, d.n_nodes))(
        synthetic_dataset("Cora", seed=3, scale=1.0).reorder_bfs()),
    "pubmed_bfs": lambda: (lambda d: (d.edge_index, d.n_nodes))(
        synthetic_dataset("Pubmed", seed=1, scale=0.5).reorder_bfs()),
    # 30 of 256 draws accepted: 1,000 negatives take a second round
    "dense_two_rounds": lambda: (_dense(16, 15), 16),
    # 2 of 256 accepted: 1,000 negatives exhaust the attempts, short
    "dense_short": lambda: (_dense(16, 1), 16),
    "complete": lambda: (_dense(12, 0), 12),
}


def _csr(ei, n):
    ip, col = B.csr_from_edge_index(ei, n)
    return torch.as_tensor(ip), torch.as_tensor(col)


def _native_pairs(ei, n, num, seed):
    keys = native.load().negative_sampling(B.edge_keys(ei, n), n, num, seed)
    return np.stack([keys // n, keys % n])


@pytest.mark.parametrize("graph,num,seed", [
    ("cora_bfs", 1, 0),
    ("cora_bfs", 1000, 1),
    ("cora_bfs", None, 0),
    ("cora_bfs", None, 3000000001),
    ("cora_bfs", None, 2**62 - 1),
    ("pubmed_bfs", None, 2147483731),
    ("pubmed_bfs", 70000, 0),
    ("dense_two_rounds", 1000, 5),
    ("dense_two_rounds", 1000, 0),
    ("dense_short", 1000, 9),
    ("dense_short", 20, 0),
    ("complete", 100, 3),
])
def test_plain_matches_the_native_sampler(graph, num, seed):
    assert native.loaded()
    ei, n = GRAPHS[graph]()
    num = ei.shape[1] if num is None else num
    want = _native_pairs(ei, n, num, seed)
    got = N.negatives(*_csr(ei, n), n, num, seed)
    assert got.dtype == torch.int64 and got.shape[0] == 2
    assert np.array_equal(got.numpy(), want)
    if graph == "dense_short" and num == 1000:
        assert 0 < want.shape[1] < num
    elif graph == "complete":
        assert want.shape[1] == 0
    elif graph != "dense_short":
        assert want.shape[1] == num


def test_the_wrapper_rejects():
    ip, col = _csr(*GRAPHS["cora_bfs"]())
    n = ip.shape[0] - 1
    with pytest.raises(ValueError):
        N.negatives(ip[:-1], col, n, 10, 0)
    with pytest.raises(ValueError):
        N.negatives(ip, col, n, 10, -1)
    with pytest.raises(ValueError):
        N.negatives(ip, col, n, 10, 2**64)


@pytest.mark.parametrize("graph,num,seed", [
    ("cora_bfs", None, 0),
    ("pubmed_bfs", None, 77),
    ("dense_two_rounds", 1000, 4),
    # short: the host sampler's NumPy rounds go on from the stream
    ("dense_short", 1000, 2),
    ("complete", 30, 1),
])
def test_the_graph_draw_is_the_host_sampler(graph, num, seed):
    """``Trainer._graph_negatives`` (the route of a train graph on a card,
    here over the plain version) gives ``B.negative_sampling``'s links for
    the same generator and leaves the generator where it does, or raises
    where it does; ``negatives.short`` counts the draws that ran out."""
    ei, n = GRAPHS[graph]()
    num = ei.shape[1] if num is None else num
    ip, col = _csr(ei, n)
    tr = types.SimpleNamespace(ds=types.SimpleNamespace(edge_index=ei, n_nodes=n),
                               g=types.SimpleNamespace(indptr=ip, col=col))
    short = N.negatives.short
    outs = []
    for draw in (lambda r: Trainer._graph_negatives(tr, num, r),
                 lambda r: B.negative_sampling(ei, n, num, r)):
        rng = np.random.default_rng(seed)
        try:
            outs.append((draw(rng).copy(), rng.integers(2**62)))
        except RuntimeError as e:
            outs.append((str(e), rng.integers(2**62)))
    assert isinstance(outs[0][0], type(outs[1][0]))
    if isinstance(outs[0][0], str):
        assert outs[0] == outs[1]
    else:
        assert np.array_equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]
    assert N.negatives.short - short == (graph in ("complete", "dense_short"))


EPOCH_KW = dict(model="gcn", mplayers=1, hiddim=16, ln=True, res=True, jk=True,
                use_xlin=True, tailact=True, gnndp=0.0, xdp=0.0, tdp=0.0,
                gnnedp=0.0, predp=0.0, preedp=0.0, maskinput=True,
                batch_size=128, linkbatchsize=64, testbs=256, pad_deg=16,
                pad_deg2=16, ell_tables=True, k_small=4)


def _csr_positions(mp):
    return mp["csr"] if isinstance(mp, dict) else mp


@pytest.fixture(scope="module")
def cora():
    return synthetic_dataset("Cora", seed=0, scale=0.3).reorder_bfs()


@pytest.mark.parametrize("route", ["host", "graph"])
def test_an_epoch_draws_the_parents_negatives(cora, route, monkeypatch):
    """One epoch's step arguments, its generator seed and the stream after
    it, against the parent's derivation: the permutation, then
    ``B.negative_sampling`` from the same generator, then the seed.  On the
    CPU the trainer keeps the host sampler ("host"); "graph" takes the
    route of a train graph on a card (the plain version here)."""
    cfg = Config(**EPOCH_KW)
    tr = Trainer(cfg, cora, device="cpu")
    state = tr.init_state(0)
    if route == "graph":
        monkeypatch.setattr(tr, "_graph_device", torch.device("cuda"))
    host = []
    monkeypatch.setattr(B, "negative_sampling",
                        lambda *a, _f=B.negative_sampling: host.append(1) or _f(*a))
    calls = []

    def recording(state, pos, neg, mp, gen, inv_p=None, inv_n=None):
        calls.append((pos, neg, _csr_positions(mp), inv_p, inv_n,
                      gen.initial_seed()))
        return state, torch.zeros(())

    monkeypatch.setattr(tr, "train_step", recording)
    rng = np.random.default_rng(11)
    tr.train_epoch(state, rng, 1)
    monkeypatch.undo()
    assert len(host) == (route == "host")

    ref = np.random.default_rng(11)
    e, bs = tr.train_edges.shape[1], cfg.batch_size
    perm = ref.permutation(e)
    neg = B.negative_sampling(cora.edge_index, cora.n_nodes, e, ref)
    seed = int(ref.integers(2**31))
    assert rng.integers(2**62) == ref.integers(2**62)
    assert len(calls) == e // bs >= 3
    for i, (pos_b, neg_b, mp, inv_p, inv_n, gen_seed) in enumerate(calls):
        idx = perm[i * bs:(i + 1) * bs]
        pe, ne, want_mp, ip, inn = tr.prepare_batch(tr.train_edges[:, idx],
                                                    neg[:, idx], idx)
        assert torch.equal(pos_b, pe) and torch.equal(neg_b, ne)
        assert torch.equal(mp, _csr_positions(want_mp))
        assert torch.equal(inv_p, ip) and torch.equal(inv_n, inn)
        assert gen_seed == seed


def test_a_dataset_edge_list_holds_both_directions():
    """The graph draw reads row u of the train CSR where the host sampler
    reads the keys of ``ds.edge_index``: the same pairs, as long as the
    dataset's edge list holds both directions, as its loaders build it."""
    ds = synthetic_dataset("Citeseer", seed=2, scale=0.5).reorder_bfs()
    ei = ds.edge_index
    assert np.array_equal(B.edge_keys(ei, ds.n_nodes),
                          B.edge_keys(ei[::-1], ds.n_nodes))
    g = ds.as_graph()
    ip, col = g.indptr.numpy(), g.col.numpy()
    rows = np.repeat(np.arange(ds.n_nodes), np.diff(ip))
    csr_keys = rows * ds.n_nodes + col[:ip[-1]]
    assert np.array_equal(csr_keys, np.unique(B.edge_keys(ei, ds.n_nodes)))

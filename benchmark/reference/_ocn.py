"""Plain PyTorch and NumPy reference of OCN-family link prediction on one
graph, shared by the configurations' references (ocn_collab.py, ocnp_collab.py).

It follows the published method (qingpingmo/OCN: a GIN encoder, candidate
common-neighbour frames of each target link, an MLP head) and works out again
every choice of the measured program that a run's numbers depend on, from the
same inputs (the seed, the graph arrays and the configuration), without taking
anything the program made: the BFS relabelling of the nodes, the row-capped
A^2, the frozen neighbour windows of each epoch (ELL offsets), the degree
sort of each batch (the dual-K split), the maskinput removal of a batch's
links, the negatives of an epoch, the initial weights and every dropout draw
(same generators, same draws, in the same order).  The dense compare, the
gathers and the sums are plain torch; nothing here is fused or hand-written.

Layout constants of the program that the draws depend on are stated here:
PAD (the 4,096 zero entries at the end of its adjacency arrays, one DropAdj
draw each) and the seeds of its epoch and eval generators.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAD = 4096
ELL_MULT, ELL_ADD = 0x9E3779B1, 0x85EBCA77
EVAL_SEED_MULT, EVAL_FOLD_MULT = 0x9E3779B1, 0x85EBCA77
SPLITMIX_GAMMA = np.uint64(0x9E3779B97F4A7C15)


# ----------------------------------------------------------------- the graph
def symmetrize(edge_index: np.ndarray, n: int) -> np.ndarray:
    ei = np.asarray(edge_index, np.int64)
    both = np.concatenate([ei, ei[::-1]], axis=1)
    both = both[:, both[0] != both[1]]
    key = np.unique(both[0] * np.int64(n) + both[1])
    return np.stack([key // n, key % n])


def csr(sym: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr, col) int64 with columns sorted within each row."""
    order = np.lexsort((sym[1], sym[0]))
    row, col = sym[0][order], sym[1][order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=indptr[1:])
    return indptr, col.astype(np.int64)


def bfs_order(train: np.ndarray, n: int) -> np.ndarray:
    """Nodes in level-synchronous BFS order from the highest-degree
    unvisited node, each level in id order."""
    indptr, col = csr(symmetrize(train.T, n), n)
    deg = indptr[1:] - indptr[:-1]
    visited = np.zeros(n, bool)
    parts = []
    for seed in np.argsort(-deg):
        if visited[seed]:
            continue
        frontier = np.asarray([seed], np.int64)
        visited[seed] = True
        while frontier.size:
            parts.append(frontier)
            starts, counts = indptr[frontier], deg[frontier]
            total = int(counts.sum())
            if total == 0:
                break
            offs = np.repeat(starts + counts, counts)
            idx = np.arange(total) + offs - np.repeat(np.cumsum(counts), counts)
            nbrs = np.unique(col[idx])
            nbrs = nbrs[~visited[nbrs]]
            visited[nbrs] = True
            frontier = nbrs
    return np.concatenate(parts) if parts else np.arange(n)


def relabel(data: Dict) -> Dict:
    """The run's arrays with nodes renumbered in BFS order."""
    n = data["n"]
    order = bfs_order(data["train"], n)
    remap = np.empty(n, np.int64)
    remap[order] = np.arange(n)
    out = {k: remap[v] for k, v in data.items()
           if k in ("train", "valid", "test", "valid_neg", "test_neg")}
    out.update(n=n, x=data["x"][order])
    return out


class Adj:
    """A CSR adjacency (structure and values) on a device."""

    def __init__(self, indptr: np.ndarray, col, val, n: int, device):
        self.n = n
        self.indptr_np = np.asarray(indptr, np.int64)
        self.deg_np = self.indptr_np[1:] - self.indptr_np[:-1]
        self.indptr = torch.as_tensor(self.indptr_np, device=device)
        self.deg = torch.as_tensor(self.deg_np, device=device)
        self.col = torch.as_tensor(col, dtype=torch.int64, device=device)
        self.val = torch.as_tensor(val, dtype=torch.float32, device=device)
        self.row = torch.repeat_interleave(
            torch.arange(n, device=device), self.deg)

    @property
    def nnz(self) -> int:
        return int(self.col.numel())

    def keys_np(self) -> np.ndarray:
        return (np.repeat(np.arange(self.n, dtype=np.int64), self.deg_np) * self.n
                + self.col.cpu().numpy())


def graph(edges: np.ndarray, n: int, device) -> Adj:
    """The symmetric unit-valued adjacency of (E, 2) undirected edges."""
    indptr, col = csr(symmetrize(edges.T, n), n)
    return Adj(indptr, col, np.ones(col.shape[0], np.float32), n, device)


def two_hop(a: Adj, cap: int) -> Adj:
    """A^2 with path counts, each row cut to its ``cap`` largest counts
    (ties to the smaller column), columns sorted."""
    n, dev = a.n, a.col.device
    m = torch.sparse_coo_tensor(torch.stack([a.row, a.col]), a.val, (n, n),
                                check_invariants=False).coalesce()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        p = torch.sparse.mm(m, m).coalesce()
    row, col = p.indices()
    cnt = p.values()
    bits_n = max(int(n).bit_length(), 1)
    bits_c = 62 - 2 * bits_n
    top = int(cnt.max().item()) if cnt.numel() else 0
    if top >= (1 << bits_c):
        raise ValueError(f"A^2 count {top} does not fit the sort key")
    key = (row << (bits_c + bits_n)) | (((1 << bits_c) - 1 - cnt.long()) << bits_n) | col
    key, order = torch.sort(key)
    row, col, cnt = row[order], col[order], cnt[order]
    counts = torch.bincount(row, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    keep = (torch.arange(row.numel(), device=dev) - start[row]) < cap
    row, col, cnt = row[keep], col[keep], cnt[keep]
    order = torch.argsort(row * n + col)
    row, col, cnt = row[order], col[order], cnt[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(torch.bincount(row, minlength=n).cpu().numpy(), out=indptr[1:])
    return Adj(indptr, col, cnt.float(), n, dev)


def packs(a: Adj, n: int) -> bool:
    """Whether the counts fit the program's col|count int32 entries."""
    bits = max(int(n - 1).bit_length(), 1)
    return float(a.val.max().item()) < (1 << (31 - bits))


def draw_offsets(deg: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    slack = np.maximum(deg.astype(np.int64) - k, 0)
    off = (rng.random(deg.shape[0]) * (slack + 1)).astype(np.int64)
    return np.minimum(off, slack)


def epoch_offsets(epoch: int, deg1: np.ndarray, deg2: np.ndarray, k1: int,
                  k2: int) -> Tuple[np.ndarray, np.ndarray]:
    """The frozen window offsets of an epoch: the train graph's rows at
    width k1, then A^2's at k2, from one generator of the epoch number."""
    rng = np.random.default_rng((epoch * ELL_MULT + ELL_ADD) & 0xFFFFFFFF)
    return draw_offsets(deg1, k1, rng), draw_offsets(deg2, k2, rng)


def window_entries(a: Adj, off: np.ndarray, k: int) -> np.ndarray:
    """(n, k) entries of each row's frozen window of width k at offsets
    ``off``, each ``col | count << col_bits`` (the program's packed int32
    layout, col_bits = the bits of n - 1); -1 on lanes past the row's
    degree, which hold no entry of the row."""
    bits = max(int(a.n - 1).bit_length(), 1)
    lane = np.arange(k, dtype=np.int64)[None, :]
    ok = lane < np.minimum(a.deg_np, k)[:, None]
    pos = np.where(ok, a.indptr_np[:-1, None] + off.astype(np.int64)[:, None] + lane, 0)
    col = a.col.cpu().numpy().astype(np.int64)
    val = a.val.cpu().numpy().astype(np.int64)
    return np.where(ok, col[pos] | (val[pos] << bits), -1)


def edge_positions(a: Adj, edges: np.ndarray) -> np.ndarray:
    """(E, 2) CSR positions of u->v and v->u of each edge."""
    keys = a.keys_np()
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    return np.stack([np.searchsorted(keys, u * a.n + v),
                     np.searchsorted(keys, v * a.n + u)], axis=1)


def _splitmix(s: np.ndarray) -> np.ndarray:
    z = s.copy()
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def epoch_negatives(sym: np.ndarray, n: int, num: int, seed: int) -> np.ndarray:
    """``num`` non-edges (2, num): pairs of splitmix64 draws from ``seed``
    taken mod n, dropping self pairs and edges of ``sym`` (the program's
    host sampler)."""
    skeys = np.sort(sym[0] * n + sym[1])
    out: List[np.ndarray] = []
    got, done = 0, 0
    s0 = np.uint64(seed if seed else 1)
    with np.errstate(over="ignore"):
        while got < num:
            block = max(2 * (num - got) + 1024, 1 << 16)
            k = np.arange(2 * done + 1, 2 * (done + block) + 1, dtype=np.uint64)
            z = _splitmix(s0 + k * SPLITMIX_GAMMA)
            u = (z[0::2] % np.uint64(n)).astype(np.int64)
            v = (z[1::2] % np.uint64(n)).astype(np.int64)
            key = u * n + v
            idx = np.minimum(np.searchsorted(skeys, key), skeys.size - 1)
            ok = (u != v) & (skeys[idx] != key)
            out.append(key[ok])
            got += int(ok.sum())
            done += block
    keys = np.concatenate(out)[:num]
    return np.stack([keys // n, keys % n])


# ----------------------------------------------------------- frames of links
def windows(a: Adj, nodes: torch.Tensor, k: int, off: Optional[torch.Tensor] = None,
            u: Optional[torch.Tensor] = None, val: Optional[torch.Tensor] = None):
    """Each node's neighbour window of width k: (ids, weights), ids the
    sentinel n on empty lanes.  A row longer than k takes k consecutive
    entries from its offset (``off``: frozen per node; ``u``: a uniform
    per row, offset floor(u * (deg - k + 1)); neither: 0), weighted deg/k."""
    deg = a.deg[nodes]
    start = a.indptr[nodes]
    lane = torch.arange(k, device=nodes.device)[None, :]
    capped = deg > k
    w_row = torch.where(capped, deg.float() / k, 1.0)
    valid = lane < torch.clamp(deg, max=k)[:, None]
    if off is not None:
        woff = off[nodes]
    elif u is not None:
        woff = torch.where(capped, (u * (deg - k + 1).float()).int(), 0).long()
    else:
        woff = torch.zeros_like(deg)
    pos = torch.clamp(start[:, None] + woff[:, None] + lane, max=a.nnz - 1)
    vals = (a.val if val is None else val)[pos]
    ids = torch.where(valid, a.col[pos], a.n)
    w = torch.where(valid, w_row[:, None] * vals, 0.0)
    return ids, w


def lookup(q: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
           block: int = 8192) -> torch.Tensor:
    """Weight of each query id in its row's (ids, w) list (dense compare,
    ``block`` rows at a time)."""
    return torch.cat([
        torch.where(q[s:s + block, :, None] == ids[s:s + block, None, :],
                    w[s:s + block, None, :], 0.0).sum(-1)
        for s in range(0, q.shape[0], block)])


def frames(g: Adj, a2: Adj, edges: torch.Tensor, k: int, k2: int, corr: bool,
           g_off=None, a2_off=None, g_val=None, draw=None):
    """(ids, cn1, cn2) of links (2, B): cn1 marks candidates of N(i) in N(j),
    cn2 those with A^2[j, .] > 0 (less the removed target link's own path
    when ``corr``).  ``draw``: the generator of sampled windows (src, dst,
    then the A^2 rows), where no offsets are frozen."""
    b = edges.shape[1]
    rnd = (lambda: torch.rand((b,), generator=draw, device=edges.device)) \
        if draw is not None else (lambda: None)
    ids, ws = windows(g, edges[0], k, off=g_off, u=rnd(), val=g_val)
    idd, wd = windows(g, edges[1], k2, off=g_off, u=rnd(), val=g_val)
    in_dst = lookup(ids, idd, wd)
    cn1 = torch.where((in_dst != 0) & (ws != 0), ws, 0.0)
    ida, wa = windows(a2, edges[1], k2, off=a2_off, u=rnd())
    cnt = lookup(ids, ida, wa)
    if corr:
        cnt = torch.clamp(cnt - 1.0, min=0.0)
    cn2 = torch.where(ws != 0, ws * (cnt > 0).float(), 0.0)
    return ids, cn1, cn2


def col_sums(ids: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """Per entry, the sum over the chunk of the values sharing its id."""
    s = torch.zeros(n + 1, dtype=v.dtype, device=v.device)
    return s.index_add(0, ids.reshape(-1), v.reshape(-1))[ids]


def aggregate(v: torch.Tensor, ids: torch.Tensor, h: torch.Tensor,
              block: int = 8192) -> torch.Tensor:
    """out[p, b] = sum_k v[p, b, k] * h[ids[b, k]] for P value planes on one
    id array (sentinel lanes carry v = 0), ``block`` rows at a time."""
    ids = torch.clamp(ids, max=h.shape[0] - 1)
    return torch.cat([torch.einsum("pbk,bkh->pbh", v[:, s:s + block], h[ids[s:s + block]])
                      for s in range(0, ids.shape[0], block)], dim=1)


# ------------------------------------------------------------ parameters
def lecun(shape, gen: torch.Generator) -> torch.Tensor:
    w = torch.empty(shape)
    std = math.sqrt(1.0 / max(shape[1], 1)) / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(std)
    return w


def dense(p: Dict, name: str, fan_in: int, out: int, gen, bias: bool = True) -> None:
    p[f"{name}.weight"] = lecun((out, fan_in), gen)
    if bias:
        p[f"{name}.bias"] = torch.zeros(out)


def norm(p: Dict, name: str, h: int) -> None:
    p[f"{name}.weight"] = torch.ones(h)
    p[f"{name}.bias"] = torch.zeros(h)


def linear(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    out = x @ p[f"{name}.weight"].T
    b = p.get(f"{name}.bias")
    return out if b is None else out + b


def layer_norm(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


class Dropout:
    """Inverted dropout drawing its masks in call order from one generator
    (None: eval mode, no draws)."""

    def __init__(self, gen: Optional[torch.Generator]):
        self.gen = gen

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.gen is None or rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def edges(self, nnz: int, val: torch.Tensor, rate: float) -> torch.Tensor:
        """DropAdj on the values: one draw per entry of the padded array."""
        if self.gen is None or rate <= 1e-6:
            return val
        keep = torch.rand(nnz + PAD, generator=self.gen, device=val.device)[:nnz] < 1.0 - rate
        return torch.where(keep, val * (1.0 / (1.0 - rate)), 0.0)


# ---------------------------------------------------------------- encoder
def gin_params(p: Dict, m: Dict, f_in: int, gen) -> None:
    """One GIN layer (Linear without bias, sum aggregation, bias), its
    LayerNorm and the JK weight, drawn in the program's order."""
    h = m["hiddim"]
    dense(p, "encoder.convs.0.lin", f_in, h, gen, bias=False)
    p["encoder.convs.0.bias"] = torch.zeros(h)
    norm(p, "encoder.norms.0", h)
    if m["jk"]:
        p["encoder.jkparams"] = torch.empty(1).normal_(0.0, 1.0, generator=gen)


def gin(p: Dict, m: Dict, x: torch.Tensor, a: Adj, val: torch.Tensor,
        drop: Dropout) -> torch.Tensor:
    """h = JK(relu(drop(LN(A (drop(x) W) + b)))) [+ x where widths match]."""
    x = drop(x, m["xdp"])
    v = drop.edges(a.nnz, val, m["gnnedp"])
    xw = linear(p, "encoder.convs.0.lin", x)
    agg = torch.zeros(a.n, xw.shape[1], device=x.device, dtype=xw.dtype)
    agg = agg.index_add(0, a.row, v[:, None] * xw[a.col]) + p["encoder.convs.0.bias"]
    if m["ln"]:
        agg = layer_norm(p, "encoder.norms.0", agg)
    x1 = torch.relu(drop(agg, m["gnndp"]))
    x = x1 + x if m["res"] and x1.shape[-1] == x.shape[-1] else x1
    if m["jk"]:
        x = x * p["encoder.jkparams"][0]
    return x


# ------------------------------------------------------------------ MLPs
def mlp_params(p: Dict, kind: str, name: str, h: int, gen) -> None:
    if kind == "xij":
        dense(p, f"{name}.dense.0", h, h, gen)
        norm(p, f"{name}.norm.0", h)
    elif kind == "cn":
        for i in range(3):
            dense(p, f"{name}.dense.{i}", h, h, gen)
        norm(p, f"{name}.norm.0", h)
    else:
        dense(p, f"{name}.dense.0", h, h, gen)
        dense(p, f"{name}.dense.1", h, 1, gen)
        norm(p, f"{name}.norm.0", h)


def xij_mlp(p, name, x, drop, rate):
    """Linear, LN, dropout, ReLU (the tail identity of ``tailact``)."""
    return torch.relu(drop(layer_norm(p, f"{name}.norm.0", linear(p, f"{name}.dense.0", x)), rate))


def cn_mlp(p, name, x, drop, rate):
    """Linear, dropout, ReLU, Linear, LN, dropout, ReLU, Linear."""
    x = torch.relu(drop(linear(p, f"{name}.dense.0", x), rate))
    x = layer_norm(p, f"{name}.norm.0", linear(p, f"{name}.dense.1", x))
    x = torch.relu(drop(x, rate))
    return linear(p, f"{name}.dense.2", x)


def head(p, xcn1, xcn2, xij, drop, rate):
    """lin(s0 * xcn1 + s0 s1 * xcn2 + beta * xij), s = sigmoid(alpha)."""
    s = torch.sigmoid(p["predictor.alpha"])
    z = s[0] * xcn1
    z = z + (s[0] * s[1]) * xcn2
    z = z + p["predictor.beta"] * xij
    z = torch.relu(drop(layer_norm(p, "predictor.lin.norm.0",
                                   linear(p, "predictor.lin.dense.0", z)), rate))
    return linear(p, "predictor.lin.dense.1", z).reshape(-1)


# ------------------------------------------------------------------ Adam
def adam(p: Dict, grads: Dict, st: Dict, lrs: Dict, t: int) -> None:
    b1, b2, eps = 0.9, 0.999, 1e-8
    for name, g in grads.items():
        m, v = st.setdefault(name, (torch.zeros_like(g), torch.zeros_like(g)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        st[name] = (m, v)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        denom = v.sqrt() / math.sqrt(bc2) + eps
        p[name] = (p[name] - (lrs[name] / bc1) * m / denom).detach()


def simple_loss(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    return -F.logsigmoid(pos).mean() - F.logsigmoid(-neg).mean()

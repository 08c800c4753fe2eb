"""The reference's two runs, shared by the configurations: the first steps
of epoch 1 (``train``), with what the program derives for a later epoch's
last batch, and one Hits@K evaluation (``evaluate``), each from the run's
seed and graph arrays.  A configuration file gives its model fields
(``model``), its parameters in the program's draw order (``params``) and
its predictor (``predict``).
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from reference import _ocn as R


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls with TF32 off (the configuration's precision), or on
    (the control's)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def deterministic():
    """Sums in one fixed order on the card: index_add and the backward of
    the gathers sort their indices instead of adding atomically, so two runs
    of the reference agree bit for bit.  Without it a scalar leaf's
    gradient, a sum over every link of the batch with cancellation, moves
    from run to run with the order of the atomic adds."""
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic")
            yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


def model(cfg: Dict) -> Dict:
    """The configuration's model fields, with the links of a training chunk
    (the largest divisor of batch_size at most linkbatchsize, or 4096)."""
    m = dict(cfg["model"])
    b = int(m["batch_size"])
    target = int(m["linkbatchsize"]) if int(m["linkbatchsize"]) > 0 else 4096
    m["chunk"] = next(c for c in range(min(b, target), 0, -1) if b % c == 0)
    return m


def init(params: Callable, m: Dict, f_in: int, seed: int, device) -> Dict:
    """The initial parameters: one CPU generator seeded with the run's seed,
    the encoder's draws first, then the predictor's."""
    gen = torch.Generator().manual_seed(int(seed))
    p: Dict[str, torch.Tensor] = {}
    params(p, m, f_in, gen)
    return {k: v.to(device) for k, v in p.items()}


def split_plan(m: Dict, deg: np.ndarray, src: np.ndarray):
    """(small positive chunks, small negative chunks) of a batch, or None:
    the shares of train sources and of nodes of degree <= k_small."""
    ks, c = m["k_small"], m["chunk"]
    if ks <= 0 or ks >= m["pad_deg"]:
        return None
    nchunk = m["batch_size"] // c
    nsp = min(nchunk, int(float(np.mean(deg[src] <= ks)) * nchunk))
    nsn = min(nchunk, int(float(np.mean(deg <= ks)) * nchunk))
    return (nsp, nsn) if nsp + nsn else None


def _inverse(order: np.ndarray) -> np.ndarray:
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    return inv


def last_epoch(m: Dict, pos_all: np.ndarray, sym: np.ndarray, g, a2, e2p: np.ndarray,
               rng: np.random.Generator, epoch: int) -> Dict:
    """What the program derives for its epoch ``epoch`` (>= 2), from the
    run's train generator past epoch 1's draws (each epoch: a permutation of
    the train links, the negatives' seed, the seed of the step's generator):
    the epoch's last full batch in the dual-K order (positive and negative
    links, their inverse orders, the mask's CSR positions), the seed of the
    batch's draws, and the window offsets and entries of the epoch's
    refresh of the tables (the latest epoch e <= ``epoch`` with (e - 1) a
    multiple of ell_refresh)."""
    e, b = pos_all.shape[1], m["batch_size"]
    for _ in range(2, epoch + 1):
        perm = rng.permutation(e)
        neg_seed = int(rng.integers(1, 2 ** 62))
        gen_seed = int(rng.integers(2 ** 31))
    neg = R.epoch_negatives(sym, g.n, e, neg_seed)
    last = e // b
    idx = perm[(last - 1) * b:last * b]
    pb, nb = pos_all[:, idx], neg[:, idx]
    sp = np.argsort(g.deg_np[pb[0]], kind="stable")
    sn = np.argsort(g.deg_np[nb[0]], kind="stable")
    k, k2 = m["pad_deg"], m["pad_deg2"]
    refresh = epoch - (epoch - 1) % max(int(m["ell_refresh"]), 1)
    o1, o2 = R.epoch_offsets(refresh, g.deg_np, a2.deg_np, k, k2)
    return {"epoch": epoch, "pos": pb[:, sp], "inv_p": _inverse(sp),
            "mask": np.maximum(e2p[idx[sp]].reshape(-1), 0),
            "neg": nb[:, sn], "inv_n": _inverse(sn), "seed": gen_seed,
            "tables": {"off1": o1, "ell1": R.window_entries(g, o1, k),
                       "off2": o2, "ell2": R.window_entries(a2, o2, k2)}}


def train(cfg: Dict, predict: Callable, params: Callable, data: Dict, seed: int,
          steps: int, device, tf32: bool = False, fault: str = "",
          epochs: int = 1) -> Dict:
    """The first ``steps`` optimizer steps of epoch 1: each step's loss, the
    first step's gradient of every parameter, and the parameters before
    step 1 and after the last; with ``epochs`` > 1 also ``last_epoch`` of
    that epoch.  Sums run in a fixed order (``deterministic``).
    ``fault="half_batch"`` takes each step's loss over the first half of its
    positive and negative links only (a planted fault, for the limits)."""
    m = model(cfg)
    with precision(tf32), deterministic():
        d = R.relabel(data)
        n = d["n"]
        g = R.graph(d["train"], n, device)
        a2 = R.two_hop(g, m["adj2_cap"])
        if not R.packs(a2, n):
            raise NotImplementedError("A^2 counts do not pack: the program leaves "
                                      "the window tables off, which this reference "
                                      "does not follow")
        k, k2 = m["pad_deg"], m["pad_deg2"]
        o1, o2 = R.epoch_offsets(1, g.deg_np, a2.deg_np, k, k2)
        o1, o2 = (torch.as_tensor(o, device=device) for o in (o1, o2))
        pos_all = d["train"].T
        e = pos_all.shape[1]
        rng = np.random.default_rng([int(seed), 1])
        perm = rng.permutation(e)
        sym = R.symmetrize(pos_all, n)
        neg_all = R.epoch_negatives(sym, n, e, int(rng.integers(1, 2 ** 62)))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(2 ** 31)))
        p = init(params, m, d["x"].shape[1], seed, device)
        p0 = {kk: v.clone() for kk, v in p.items()}
        x = torch.as_tensor(d["x"], device=device)
        e2p = R.edge_positions(g, d["train"])
        plan = split_plan(m, g.deg_np, pos_all[0])
        b, c = m["batch_size"], m["chunk"]
        nchunk = b // c
        st = {"ema": torch.zeros((), device=device), "n": 0}
        adam_st: Dict = {}
        lrs = {kk: (m["gnnlr"] if kk.startswith("encoder.") else m["prelr"]) for kk in p}
        losses, grads1 = [], None
        for t in range(1, steps + 1):
            idx = perm[(t - 1) * b:t * b]
            pb, nb = pos_all[:, idx], neg_all[:, idx]
            sp = np.argsort(g.deg_np[pb[0]], kind="stable")
            sn = np.argsort(g.deg_np[nb[0]], kind="stable")
            pb, nb, idx = pb[:, sp], nb[:, sn], idx[sp]
            val = g.val.clone()
            val[torch.as_tensor(e2p[idx].reshape(-1), device=device)] = 0.0
            for v in p.values():
                v.requires_grad_(True)
            drop = R.Dropout(gen)
            h = R.gin(p, m, x, g, val, drop)
            nsp, nsn = plan if plan is not None else (0, 0)
            bodies = [(np.concatenate([pb[:, :nsp * c], nb[:, :nsn * c]], 1), nsp,
                       m["k_small"]),
                      (np.concatenate([pb[:, nsp * c:], nb[:, nsn * c:]], 1),
                       nchunk - nsp, k)] if plan is not None else \
                [(np.concatenate([pb, nb], 1), nchunk, k)]
            outs = []
            for edges, npos, kw in bodies:
                et = torch.as_tensor(edges, device=device)
                for i in range(et.shape[1] // c):
                    ch = et[:, i * c:(i + 1) * c]
                    ids, v1, v2 = R.frames(g, a2, ch, kw, k2, corr=i < npos,
                                           g_off=o1, a2_off=o2, g_val=val)
                    outs.append(predict(p, m, h, ids, v1, v2, ch, st, drop, True))
            s = torch.cat(outs)
            if plan is not None:
                nbp = (nchunk - nsp) * c
                small = s[:(nsp + nsn) * c]
                big = s[(nsp + nsn) * c:]
                pos_s = torch.cat([small[:nsp * c], big[:nbp]])
                neg_s = torch.cat([small[nsp * c:], big[nbp:]])
            else:
                pos_s, neg_s = s[:b], s[b:]
            if fault == "half_batch":
                pos_s, neg_s = pos_s[:b // 2], neg_s[:b // 2]
            loss = R.simple_loss(pos_s, neg_s)
            names = list(p)
            gl = torch.autograd.grad(loss, [p[kk] for kk in names], allow_unused=True)
            gd = {kk: (gg if gg is not None else torch.zeros_like(p[kk]))
                  for kk, gg in zip(names, gl)}
            losses.append(float(loss.detach()))
            if t == 1:
                grads1 = {kk: v.detach().clone() for kk, v in gd.items()}
            R.adam(p, gd, adam_st, lrs, t)
            del h, outs, s, loss, gl, gd
        out = {"losses": losses, "grads1": grads1, "p0": p0,
               "p_last": {kk: v.detach() for kk, v in p.items()}}
        if epochs > 1:
            out["last_epoch"] = last_epoch(m, pos_all, sym, g, a2, e2p, rng, epochs)
        return out


def _score_batches(predict, p, m, st, h, g, a2, edges: np.ndarray, k: int,
                   offs, fold0: int, device) -> np.ndarray:
    bs = m["testbs"]
    out = []
    for start in range(0, edges.shape[0], bs):
        ch = edges[start:start + bs].T
        c = ch.shape[1]
        if bs - c:
            ch = np.concatenate([ch, np.zeros((2, bs - c), ch.dtype)], axis=1)
        valid = torch.zeros(bs, device=device)
        valid[:c] = 1.0
        et = torch.as_tensor(ch, device=device)
        draw = None
        if offs is None:
            draw = torch.Generator(device=device)
            draw.manual_seed(m["seed"] * R.EVAL_SEED_MULT + fold0 * R.EVAL_FOLD_MULT + start)
        o1, o2 = offs if offs is not None else (None, None)
        ids, v1, v2 = R.frames(g, a2, et, k, m["pad_deg2"], corr=False,
                               g_off=o1, a2_off=o2, draw=draw)
        v1, v2 = v1 * valid[:, None], v2 * valid[:, None]
        s = predict(p, m, h, ids, v1, v2, et, st, R.Dropout(None), False)
        out.append(s[:c].cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def _score_split(predict, p, m, st, h, g, a2, edges, offs, device) -> np.ndarray:
    n = edges.shape[0]
    ks = m["k_small"]
    if not (m["dual_k_eval"] and 0 < ks < m["pad_deg"] and n > m["testbs"]):
        return _score_batches(predict, p, m, st, h, g, a2, edges, m["pad_deg"],
                              offs, 0, device)
    deg = g.deg_np[edges[:, 0]]
    sp = np.argsort(deg, kind="stable")
    at = (int(np.sum(deg <= ks)) // m["testbs"]) * m["testbs"]
    se = edges[sp]
    out = np.concatenate([
        _score_batches(predict, p, m, st, h, g, a2, se[:at], ks, offs, 1, device),
        _score_batches(predict, p, m, st, h, g, a2, se[at:], m["pad_deg"], offs, 2,
                       device)])
    inv = np.empty(n, np.int64)
    inv[sp] = np.arange(n)
    return out[inv]


def evaluate(cfg: Dict, predict: Callable, params: Callable, data: Dict, seed: int,
             device, tf32: bool = False, state: Optional[Dict] = None) -> Dict:
    """Scores of every eval split, in the splits' order, of the initial
    parameters with epoch 1's window tables on the train graph: train,
    valid and valid_neg on the train graph, test and test_neg re-encoded on
    the train+valid graph, whose windows are sampled per batch."""
    m = model(cfg)
    with precision(tf32), torch.no_grad():
        d = R.relabel(data)
        n = d["n"]
        g = R.graph(d["train"], n, device)
        full = R.graph(np.concatenate([d["train"], d["valid"]]), n, device)
        a2 = R.two_hop(g, m["adj2_cap"])
        fa2 = R.two_hop(full, m["adj2_cap"])
        if not R.packs(a2, n):
            raise NotImplementedError("A^2 counts do not pack: the program leaves "
                                      "the window tables off, which this reference "
                                      "does not follow")
        o1, o2 = R.epoch_offsets(1, g.deg_np, a2.deg_np, m["pad_deg"], m["pad_deg2"])
        offs = tuple(torch.as_tensor(o, device=device) for o in (o1, o2))
        p = init(params, m, d["x"].shape[1], seed, device)
        st = state or {"ema": torch.zeros((), device=device), "n": 0}
        x = torch.as_tensor(d["x"], device=device)
        h = R.gin(p, m, x, g, g.val, R.Dropout(None))
        out = {}
        for name in ("train", "valid", "valid_neg"):
            out[name] = _score_split(predict, p, m, st, h, g, a2, d[name], offs, device)
        hf = R.gin(p, m, x, full, full.val, R.Dropout(None))
        for name in ("test", "test_neg"):
            out[name] = _score_split(predict, p, m, st, hf, full, fa2, d[name], None,
                                     device)
        return out

"""The step program (ocn_tpu_torch/train/step_graph.py) on the CPU: the
port of the JAX package's compiled train step, captured once as a CUDA
graph and replayed on the card.

Here ``StepProgram.run`` calls the same step function on its static
buffers, so these tests reach every line but the capture and the replay:
three steps with an ELL refresh between them, bit for bit against the
trainer's eager step (dropout on) and within rtol 1e-4 of the JAX
package's (dropout off), for cn5 on the ELL tables with the dual-K split
and frame groups in bfloat16, the window table, and cn3.  A fake graph
(``FakeGraph``: its capture runs the step in Python, its replay runs
nothing) holds the launch counters' replay rule, a new state starting a
new program and a capture error raising; a dispatch mode holds every
configuration of the capture rule free of host reads inside the step; and
``train_epoch`` reads the card once an epoch.  The captured step itself is
held against the eager one on the card (tests/test_torch_cuda.py)."""
import collections
import contextlib
import copy
import dataclasses
import os
import re
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ocn_tpu.data.loaders import synthetic_dataset as jsynthetic
from ocn_tpu_torch.config import Config as TConfig
from ocn_tpu_torch.data.loaders import synthetic_dataset as tsynthetic
from ocn_tpu_torch.ops import frame as tframe
from ocn_tpu_torch.ops import membership as tm
from ocn_tpu_torch.sparse import build as B
from ocn_tpu_torch.train import step_graph as SG
from ocn_tpu_torch.train.loop import Trainer as TTrainer
from torch_parity import trainer_pair
from torch_parity import native_route, one_thread  # noqa: F401 (autouse: native host code on both sides, one intra-op thread)

KW = dict(model="gcn", mplayers=2, hiddim=16, ln=True, res=True, jk=True,
          use_xlin=True, tailact=True, lnnn=True, gnndp=0.0, xdp=0.0, tdp=0.0,
          gnnedp=0.0, predp=0.0, preedp=0.0, gnnlr=0.001, prelr=0.001,
          ell_tables=False, k_small=0, maskinput=True, batch_size=64,
          linkbatchsize=16, testbs=64, pad_deg=16, pad_deg2=8)
DROPOUT = dict(gnndp=0.1, xdp=0.1, tdp=0.1, gnnedp=0.1, predp=0.1, preedp=0.1)
# the three programs held step by step: bench.py's grouped bfloat16 frames
# on the ELL tables and the dual-K split (a small body of one group, a big
# one of three), the window table, and cn3 on its tables
CASES = {
    "cn5_ell_dualk_groups": dict(ell_tables=True, k_small=4, frame_group=2,
                                 small_frac=0.5, small_frac_neg=0.25,
                                 dtype="bfloat16"),
    "cn5_window": dict(ell_tables=True, k_small=4, window_table=True),
    "cn3": dict(mplayers=1, ell_tables=True, pad_deg2=16, trndeg=16, tstdeg=16,
                depth=1, rec_k=8, probscale=4.3, proboffset=2.8, pt=0.75,
                learnpt=True, predictor="cn3"),
}


@pytest.fixture(scope="module")
def cora():
    return (jsynthetic("Cora", seed=0, scale=0.1).reorder_bfs(),
            tsynthetic("Cora", seed=0, scale=0.1).reorder_bfs())


def batches(tr, nsteps=3, seed=5):
    """``nsteps`` batches of (pos, neg, idx) from one NumPy seed."""
    e = tr.train_edges.shape[1]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(e)
    neg = B.negative_sampling(tr.ds.edge_index, tr.ds.n_nodes, e, rng)
    bs = tr.cfg.batch_size
    assert e >= nsteps * bs
    return [(tr.train_edges[:, perm[i * bs:(i + 1) * bs]],
             neg[:, perm[i * bs:(i + 1) * bs]], perm[i * bs:(i + 1) * bs])
            for i in range(nsteps)]


def state_tensors(state):
    """Every parameter and buffer (the EMA among them) and Adam moment."""
    out = {f"enc.{k}": v for k, v in state.encoder.state_dict().items()}
    out.update({f"pred.{k}": v for k, v in state.predictor.state_dict().items()})
    for i, s in enumerate(state.opt.state.values()):
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    return out


def run_steps(tr, state, steps, gen, eager, refresh=True):
    """The steps through train_step (the program) or the eager ``_step``,
    the ELL tables refreshed in place after the first; returns the losses."""
    losses = []
    for i, (pos_b, neg_b, idx) in enumerate(steps):
        if i == 1 and refresh and tr._use_ell:
            tr._refresh_ell(np.random.default_rng(8))
        pe, ne, mp, ip, inn = tr.prepare_batch(pos_b, neg_b, idx)
        if eager:
            loss = tr._step(state, pe, ne, mp, gen, ip, inn)
        else:
            state, loss = tr.train_step(state, pe, ne, mp, gen, ip, inn)
        losses.append(loss)
    return losses


@pytest.mark.parametrize("case", list(CASES))
def test_program_matches_the_eager_step(cora, case, monkeypatch):
    """Bit for bit, dropout on: the program's buffers (copied in place each
    step, the tables the trainer's own, refreshed in place) change nothing."""
    cfg = TConfig(**{**KW, **DROPOUT, **CASES[case]})
    starts = []
    start = SG.StepProgram._start
    monkeypatch.setattr(SG.StepProgram, "_start",
                        lambda self, *a: starts.append(1) or start(self, *a))
    runs = []
    for eager in (True, False):
        tr = TTrainer(cfg, cora[1], device="cpu")
        assert tr._use_ell and tr._program is not None and not tr._program.capture
        state = tr.init_state(0)
        tr._refresh_ell(np.random.default_rng(7))
        tables = dict(tr._ell)
        gen = torch.Generator().manual_seed(0)
        losses = run_steps(tr, state, batches(tr), gen, eager)
        # refreshed in place: the same tensors, new offsets
        assert all(tr._ell[k] is t for k, t in tables.items() if k != "off1_np")
        if not eager:
            # one set of buffers for the three steps; the tables' are the
            # trainer's, the rest hold the last step's inputs
            assert len(starts) == 1
            bufs = tr._program._bufs
            assert bufs["mp.ell1"] is tr._ell["tbl1"] and bufs["mp.off1"] is tr._ell["off1"]
            last = tr.prepare_batch(*batches(tr)[-1])
            for name, t in (("pos", last[0]), ("neg", last[1]), ("inv_p", last[3]),
                            ("mp.ell_flat", last[2]["ell_flat"])):
                if t is not None:  # no inverse permutations without dual-K
                    assert torch.equal(bufs[name], t) and bufs[name] is not t, name
        runs.append((torch.stack(losses), state_tensors(state)))
    (l0, s0), (l1, s1) = runs
    assert torch.equal(l0, l1) and len(set(l0.tolist())) == 3
    assert s0.keys() == s1.keys()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_program_matches_jax(cora, case):
    """The same trajectory as the JAX package's jitted step, dropout off
    (no random stream read), within rtol 1e-4."""
    kw = {**KW, **CASES[case]}
    jt, js, tt, ts = trainer_pair(kw, *cora)
    gen = torch.Generator().manual_seed(0)
    jl, tl = [], []
    for i, (pos_b, neg_b, idx) in enumerate(batches(tt)):
        if i == 1:
            jt._refresh_ell(np.random.default_rng(8))
            tt._refresh_ell(np.random.default_rng(8))
        pe, ne, mp, ip, inn = jt.prepare_batch(pos_b, neg_b, idx)
        js, loss = jt.train_step(js, pe, ne, mp, jax.random.PRNGKey(i), ip, inn)
        jl.append(float(loss))
        pe, ne, mp, ip, inn = tt.prepare_batch(pos_b, neg_b, idx)
        ts, loss = tt.train_step(ts, pe, ne, mp, gen, ip, inn)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert len(set(jl)) == 3


class FakeGraph:
    """A graph on the CPU: the warm-up runs as it is, the capture runs the
    step in Python (as a real capture does, launching nothing on the card),
    and a replay runs nothing."""

    def __init__(self, gen):
        self.gen = gen
        self.replays = 0

    @staticmethod
    def warm_up(fn):
        return fn()

    def capture(self, fn):
        return fn()

    def replay(self):
        self.replays += 1


@pytest.fixture
def counted(monkeypatch):
    """Membership on the CPU counted as its CUDA wrapper counts it (launches
    and shapes), and a caller's own Counter registered in EXTRA_COUNTERS."""
    own = collections.Counter()

    def counting(q, ids, w):
        tm.membership_counts.launches += 1
        tm.membership_counts.shapes[(q.numel() // q.shape[-1], q.shape[-1],
                                     ids.shape[-1])] += 1
        own["calls"] += 1
        return tm.membership_counts_plain(q, ids, w)

    monkeypatch.setattr(tframe, "membership_counts", counting)
    monkeypatch.setattr(SG, "EXTRA_COUNTERS", [own])
    return own


def fake_captured(tr, monkeypatch):
    monkeypatch.setattr(SG.StepProgram, "Graph", FakeGraph)
    tr._program.capture = True
    return tr


def test_replays_add_the_captured_launches(cora, counted, monkeypatch):
    """Each step counts its launches once: the warm-up in Python, the
    capture's count taken back and added by its replay, every later replay
    adding the captured increase."""
    cfg = TConfig(**{**KW, **CASES["cn5_ell_dualk_groups"]})
    per_step = {}
    for mode in ("eager", "captured"):
        tr = TTrainer(cfg, cora[1], device="cpu")
        if mode == "captured":
            fake_captured(tr, monkeypatch)
        state = tr.init_state(0)
        tr._refresh_ell(np.random.default_rng(7))
        gen = torch.Generator().manual_seed(0)
        tm.membership_counts.shapes.clear()
        counted.clear()
        rows = []
        for pos_b, neg_b, idx in batches(tr, 4):
            tm.membership_counts.launches = 0
            inputs = tr.prepare_batch(pos_b, neg_b, idx)
            tr.train_step(state, *inputs[:3], gen, *inputs[3:])
            rows.append(tm.membership_counts.launches)
        per_step[mode] = (rows, dict(tm.membership_counts.shapes), dict(counted))
        if mode == "captured":
            assert tr._program._graph.replays == 3 and tr._program.replays == 3
            assert tr._program.capture_s is not None
    # 1 small group and 3 big ones, two launches each
    assert per_step["eager"][0] == [8, 8, 8, 8]
    assert per_step["captured"] == per_step["eager"]


def test_a_new_state_starts_a_new_program(cora, monkeypatch):
    """Another TrainState, or Adam's state loaded anew, makes the next step
    a warm-up: a graph holds the tensors it was captured with."""
    cfg = TConfig(**KW)
    tr = fake_captured(TTrainer(cfg, cora[1], device="cpu"), monkeypatch)
    prog = tr._program
    steps = batches(tr, 5)
    gen = torch.Generator().manual_seed(0)

    def step(state, i):
        inputs = tr.prepare_batch(*steps[i])
        tr.train_step(state, *inputs[:3], gen, *inputs[3:])

    state = tr.init_state(0)
    step(state, 0)
    assert prog._graph is None
    step(state, 1)
    graph = prog._graph
    assert graph is not None and graph.replays == 1
    state2 = tr.init_state(1)
    step(state2, 2)
    assert prog._graph is None
    step(state2, 3)
    assert prog._graph is not graph and prog._graph.replays == 1
    # as a checkpoint restores it: new tensors with the same values
    state2.opt.load_state_dict(copy.deepcopy(state2.opt.state_dict()))
    step(state2, 4)
    assert prog._graph is None


def test_a_capture_error_raises(cora, monkeypatch):
    """No fallback: a capture that fails raises, on every later step too,
    and the program stays a captured one."""

    class Refused(FakeGraph):
        def capture(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    cfg = TConfig(**KW)
    tr = fake_captured(TTrainer(cfg, cora[1], device="cpu"), monkeypatch)
    monkeypatch.setattr(SG.StepProgram, "Graph", Refused)
    state = tr.init_state(0)
    gen = torch.Generator().manual_seed(0)
    steps = batches(tr, 3)
    inputs = tr.prepare_batch(*steps[0])
    tr.train_step(state, *inputs[:3], gen, *inputs[3:])
    for s in steps[1:]:
        inputs = tr.prepare_batch(*s)
        with pytest.raises(RuntimeError, match="capturing"):
            tr.train_step(state, *inputs[:3], gen, *inputs[3:])
        assert tr._program.capture and tr._program._graph is None


def test_the_capture_rule():
    """Single-device CUDA steps are captured; the mesh and node-sharded
    steps and the CPU are not; no Config field turns capture off."""
    assert SG.captures(TConfig(**KW), "cuda")
    assert SG.captures(TConfig(**KW), torch.device("cuda", 0))
    assert not SG.captures(TConfig(**KW), "cpu")
    assert not SG.captures(TConfig(**KW, dp_devices=2, tp_devices=2), "cuda")
    assert not SG.captures(TConfig(**KW, dp_devices=2, graph_sharding="node"), "cuda")
    assert not SG.captures(TConfig(**KW, tp_devices=2), "cuda")
    assert not any("capture" in f.name for f in dataclasses.fields(TConfig))


# aten ops that read the card from the host (a shape that depends on the
# data, or a host tensor) and so cannot sit inside a captured step
HOST_READS = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
              "aten.unique", "aten._unique2", "aten.unique_dim",
              "aten.unique_consecutive", "aten.bincount", "aten.equal",
              "aten.is_nonzero", "aten.allclose", "aten.lift_fresh",
              "aten.histc"}


# host reads made on CPU tensors only: the window matmul's check that its
# windows are contiguous (ops/frame.py _FrameMatmulMultiWindow), and the
# backward of a full max reduction (aten's evenly_distribute_backward takes
# a path without a read on CUDA tensors)
CPU_ONLY = {("aten.equal", "frame.py:forward"),
            ("aten._local_scalar_dense", "MaxBackward1")}


class HostReads(TorchDispatchMode):
    """The host-reading ops a region dispatches outside torch.optim (Adam
    reads its step count on the host only off the card), by op and the
    port's function that called it, those in CPU_ONLY left out.  A dispatch
    mode turns composite ops onto their subclass-safe paths, which read no
    value (torch.cumprod's backward tests its input for zeros on the host
    only without one): scalar_reads covers those."""

    def __init__(self):
        super().__init__()
        self.found = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        bad = name in HOST_READS or (name == "aten.repeat_interleave"
                                     and "output_size" not in (kwargs or {}))
        if name in ("aten.index", "aten.index_put", "aten.index_put_"):
            bad = bad or any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                      for t in args[1])
        if bad:
            site = _site()
            if site is not None and (name, site) not in CPU_ONLY:
                self.found[(name, site)] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def scalar_reads():
    """The port's sites that read a scalar off a tensor (aten's
    _local_scalar_dense: item(), float(), a composite op's own test) in a
    region, outside torch.optim: the CPU kernel replaced by a counting one,
    with no dispatch mode, so every op takes its usual path."""
    found = collections.Counter()

    def read(t):
        site = _site()
        if site is not None:
            # a read inside the backward: by the autograd node that made it
            node = re.search(r"autograd::generated::(\w+)::apply",
                             torch._C._get_cpp_backtrace(0, 40))
            key = ("aten._local_scalar_dense", node.group(1) if node else site)
            if key not in CPU_ONLY:
                found[key] += 1
        kind = torch.float64 if t.is_floating_point() else torch.int64
        return t.reshape(()).to(kind).numpy().item()

    lib = torch.library.Library("aten", "IMPL")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # overriding a registered kernel
        lib.impl("_local_scalar_dense", read, "CPU")
    try:
        yield found
    finally:
        lib._destroy()


def _site():
    """file:function of the port's innermost caller, None inside
    torch.optim."""
    f, site = sys._getframe(2), None
    while f is not None:
        path = f.f_code.co_filename
        if f"{os.sep}torch{os.sep}optim{os.sep}" in path:
            return None
        if site is None and f"{os.sep}ocn_tpu_torch{os.sep}" in path:
            site = f"{os.path.basename(path)}:{f.f_code.co_name}"
        f = f.f_back
    return site or "?"


# every configuration the capture rule names as captured
RULE_CASES = {
    "cn1": dict(predictor="cn1"),
    "cn5_plain": dict(pad_deg2=16),
    "cn5_ell_dualk_groups_bf16": CASES["cn5_ell_dualk_groups"],
    "cn5_window": CASES["cn5_window"],
    "cn5_hoist": dict(ell_tables=True, hoist_frames=True),
    "cn5_sddmm_cndeg": dict(two_hop_mode="sddmm", cndeg=4),
    "cn6": dict(predictor="cn6", ell_tables=True, k_small=4),
    "cn7": dict(predictor="cn7"),
    "cn8": dict(predictor="cn8"),
    "cn9": dict(predictor="cn9"),
    "cn2": dict(predictor="cn2", ell_tables=True, k_small=4, rec_k=8, trndeg=8,
                tstdeg=8, depth=1),
    "cn3": CASES["cn3"],
    "cn4": dict(predictor="cn4", rec_k=8, trndeg=8, tstdeg=8, depth=2, learnpt=True),
    "ho_stack": dict(encoder_stack="ho", model="puregcn"),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_the_step_reads_nothing_back(cora, case):
    """Captured configurations: a step (dropout on) runs no op that reads
    the card from the host, so one graph holds it whole; the first step
    under HostReads, the second under scalar_reads."""
    cfg = TConfig(**{**KW, **DROPOUT, **RULE_CASES[case]})
    tr = TTrainer(cfg, cora[1], device="cpu")
    state = tr.init_state(0)
    if tr._use_ell:
        tr._refresh_ell(np.random.default_rng(7))
    steps = batches(tr, 2)
    gen = torch.Generator().manual_seed(0)
    found = collections.Counter()
    for detector, step in zip((HostReads(), scalar_reads()), steps):
        inputs = tr.prepare_batch(*step)
        with detector as seen:
            _, loss = tr.train_step(state, *inputs[:3], gen, *inputs[3:])
        found.update(seen if isinstance(seen, collections.Counter) else seen.found)
        assert torch.isfinite(loss)
    assert not found, dict(found)


# the Tensor methods that copy a device value to the host
READS = ("item", "cpu", "tolist", "__float__", "__int__", "__bool__")


def test_an_epoch_reads_the_card_once(cora, monkeypatch):
    """train_epoch keeps every step's loss on the device and reads them in
    one transfer at the end; its mean is the mean of the steps' float32
    losses in float64, as it was when each step was read."""
    cfg = TConfig(**{**KW, **DROPOUT, **CASES["cn5_ell_dualk_groups"]})
    tr = TTrainer(cfg, cora[1], device="cpu")
    state = tr.init_state(0)
    reads = collections.Counter()
    port = os.path.dirname(os.path.dirname(SG.__file__))
    for name in READS:
        real = getattr(torch.Tensor, name)

        def counting(self, *a, _real=real, _name=name, **kw):
            if sys._getframe(1).f_code.co_filename.startswith(port):
                reads[_name] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counting)
    losses = []
    step = TTrainer.train_step

    def recording(self, *a, **kw):
        out = step(self, *a, **kw)
        losses.append(out[1])
        return out

    monkeypatch.setattr(TTrainer, "train_step", recording)
    _, mean = tr.train_epoch(state, np.random.default_rng(9), 1)
    monkeypatch.undo()
    assert len(losses) == tr.train_edges.shape[1] // cfg.batch_size >= 3
    assert dict(reads) == {"cpu": 1}
    assert mean == float(np.mean([loss.item() for loss in losses]))

"""The compiled single-device train step: one program a step, captured once
as a CUDA graph and replayed (port of ``_build_steps``,
ocn_tpu/train/loop.py:711-958, whose ``jax.jit(train_step,
donate_argnums=(0,))`` makes the whole step one XLA program).

``StepProgram`` keeps a static device buffer for every step input: the
positive and negative edges, the dual-K split's inverse permutations, the
mask positions (the CSR positions, and with the ELL tables the flat table
positions and the values cleared there) and the ELL tables with their
offsets.  A step copies its inputs into the buffers in place; the tables'
buffers are the trainer's own tensors, which ``Trainer._refresh_ell``
rewrites in place, so a step copies them only when it is given others.

On a CUDA device the first step runs eagerly on a side stream (the
warm-up, which also creates Adam's state, as torch's capture recipe asks),
the second is captured as a CUDA graph and then replayed, and every later
step is one replay: every step is a real step, none is spent on the
warm-up or the capture.  The loss comes out in a static buffer.  A capture
that fails raises; nothing falls back to the eager step.  Off the card
(``capture`` False) ``run`` calls the same step function on the same
static buffers.

The capture rule (``captures``): the single-device Trainer on CUDA is
captured, for every configuration its step runs.  The mesh step and the
node-sharded step stay eager: their gloo collectives stage tensors through
host memory, which a graph cannot hold.

Random draws: the graph reads the program's generator, registered with it
once.  A step given another generator copies that one's state in before
the replay and the advanced state back after it, so replay k draws what
eager step k would.

Launch counters: the kernels' wrappers count their launches in Python,
which a replay does not run.  The program keeps each counter's increase
over the capture, takes it back (a capture launches nothing) and adds it
on every replay.  ``EXTRA_COUNTERS`` holds a caller's own Counters for a
region; they are advanced the same way.

A state with other tensors (another TrainState, or an optimizer state
loaded anew) or inputs of other shapes start a new program: that step is
its warm-up.  The optimizer's settings (its learning rates) are read when
the graph is captured.
"""
from __future__ import annotations

import collections
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch

# the trainer's ELL tables and offsets among the mask positions: their
# buffers are the trainer's tensors (refreshed in place), never copies
TABLES = ("ell1", "off1", "ell2", "off2", "ell3", "off3")

# Counters of a caller's own (e.g. launches by shape) that a replay must
# advance as it advances the wrappers' counts; registered for a region
EXTRA_COUNTERS: List[collections.Counter] = []


def captures(cfg, device) -> bool:
    """The capture rule: the single-device step on a CUDA device is one
    captured graph; the mesh and node-sharded steps (dp_devices *
    tp_devices > 1) stay eager."""
    return torch.device(device).type == "cuda" and cfg.dp_devices * cfg.tp_devices == 1


def _counters():
    """The wrappers' launch counters: (owner, attribute) pairs holding ints,
    and Counters."""
    from ocn_tpu_torch.ops.membership import membership_counts
    from ocn_tpu_torch.ops.segment_sum import segment_sum_raw
    from ocn_tpu_torch.ops.window_gather import window_rows

    ints = [(f, "launches") for f in (membership_counts, window_rows, segment_sum_raw)]
    return ints, [membership_counts.shapes, *EXTRA_COUNTERS]


def _snapshot():
    ints, ctrs = _counters()
    return [(o, a, getattr(o, a)) for o, a in ints], [(c, dict(c)) for c in ctrs]


def _increase(before):
    """Each counter's increase since ``before`` (a _snapshot)."""
    ints, ctrs = before
    return ([(o, a, getattr(o, a) - n) for o, a, n in ints],
            [(c, {k: v - old.get(k, 0) for k, v in c.items() if v != old.get(k, 0)})
             for c, old in ctrs])


def _add(inc, sign: int = 1) -> None:
    ints, ctrs = inc
    for o, a, n in ints:
        setattr(o, a, getattr(o, a) + sign * n)
    for c, d in ctrs:
        for k, n in d.items():
            c[k] += sign * n
            if not c[k]:
                del c[k]


def _flat(pos, neg, mask_positions, inv_p, inv_n) -> Dict[str, Optional[torch.Tensor]]:
    """The step's tensor inputs by name (mask positions: None, a tensor or
    prepare_batch's dict)."""
    out = {"pos": pos, "neg": neg, "inv_p": inv_p, "inv_n": inv_n}
    if isinstance(mask_positions, dict):
        out.update({f"mp.{k}": v for k, v in mask_positions.items()})
    else:
        out["mp"] = mask_positions
    return out


def _args(bufs):
    """(pos, neg, mask_positions, inv_p, inv_n) of the buffers."""
    if "mp" in bufs:
        mp = bufs["mp"]
    else:
        mp = {k[3:]: v for k, v in bufs.items() if k.startswith("mp.")}
    return bufs["pos"], bufs["neg"], mp, bufs["inv_p"], bufs["inv_n"]


def _signature(flat):
    return tuple((k, None if t is None else (tuple(t.shape), t.dtype, t.device))
                 for k, t in flat.items())


def _state_tensors(state) -> List[torch.Tensor]:
    """Every tensor a step reads or writes in place: parameters, buffers and
    the optimizer's state."""
    out = [*state.encoder.parameters(), *state.encoder.buffers(),
           *state.predictor.parameters(), *state.predictor.buffers()]
    for s in state.opt.state.values():
        out += [v for v in s.values() if isinstance(v, torch.Tensor)]
    return out


class CudaGraph:
    """One CUDA graph of a step, its generator registered, and the side
    stream of the warm-up: the four calls StepProgram makes of the card."""

    def __init__(self, gen: torch.Generator):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(gen)

    @staticmethod
    def warm_up(fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream().wait_stream(side)
        return out

    def capture(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        with torch.cuda.graph(self.graph):
            out = fn()
        torch.cuda.synchronize()
        return out

    def replay(self) -> None:
        self.graph.replay()


class StepProgram:
    """The train step of one single-device Trainer as one program: static
    input buffers, then (``capture``) a warm-up, a capture and replays.
    ``step(state, pos, neg, mask_positions, gen, inv_p, inv_n)`` is the
    eager step returning the detached loss; ``gen`` is the generator the
    graph is registered with."""

    Graph = CudaGraph

    def __init__(self, step: Callable, gen: torch.Generator, capture: bool):
        # a weak reference: the trainer holds the program
        self._step = weakref.WeakMethod(step)
        self.gen = gen
        self.capture = capture
        self._sig = None
        self._bufs: Dict[str, Optional[torch.Tensor]] = {}
        self._held = None
        self._graph = None
        self._loss = None
        self._inc = None
        # host seconds of the capture, and the replays of its graph
        self.capture_s: Optional[float] = None
        self.replays = 0

    def run(self, state, pos, neg, mask_positions, gen: torch.Generator,
            inv_p=None, inv_n=None) -> torch.Tensor:
        """One training step on these inputs; returns the detached loss."""
        flat = _flat(pos, neg, mask_positions, inv_p, inv_n)
        sig = _signature(flat)
        if sig != self._sig or not self._same_state(state):
            self._start(flat, sig)
            loss = (self.Graph.warm_up(lambda: self._call(state, gen)) if self.capture
                    else self._call(state, gen))
            self._hold(state)
            return loss
        for k, t in flat.items():
            b = self._bufs[k]
            if t is not None and t.data_ptr() != b.data_ptr():
                b.copy_(t)
        if not self.capture:
            return self._call(state, gen)
        if self._graph is None:
            self._capture(state)
        return self._replay(gen)

    def _call(self, state, gen) -> torch.Tensor:
        pos, neg, mp, inv_p, inv_n = _args(self._bufs)
        return self._step()(state, pos, neg, mp, gen, inv_p, inv_n)

    def _start(self, flat, sig) -> None:
        """New buffers (a copy of each input; the tables themselves) and no
        graph."""
        self._graph = self._loss = self._inc = None
        self.capture_s, self.replays = None, 0
        self._bufs = {k: None if t is None else t if k[3:] in TABLES else t.clone()
                      for k, t in flat.items()}
        self._sig = sig

    def _hold(self, state) -> None:
        ts = _state_tensors(state)
        self._held = (state, ts, [t.data_ptr() for t in ts])

    def _same_state(self, state) -> bool:
        if self._held is None or state is not self._held[0]:
            return False
        ts = _state_tensors(state)
        _, held, ptrs = self._held
        return (len(ts) == len(held) and all(a is b for a, b in zip(ts, held))
                and [t.data_ptr() for t in ts] == ptrs)

    def _capture(self, state) -> None:
        t0 = time.perf_counter()
        graph = self.Graph(self.gen)
        before = _snapshot()
        loss = graph.capture(lambda: self._call(state, self.gen))
        self._inc = _increase(before)
        _add(self._inc, -1)
        self._graph, self._loss = graph, loss
        self.capture_s = time.perf_counter() - t0

    def _replay(self, gen: torch.Generator) -> torch.Tensor:
        own = gen is self.gen
        if not own:
            self.gen.set_state(gen.get_state())
        self._graph.replay()
        _add(self._inc)
        if not own:
            gen.set_state(self.gen.get_state())
        self.replays += 1
        # the buffer is the next replay's output: the caller gets a copy
        return self._loss.clone()

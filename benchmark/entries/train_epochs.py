"""Entry ``train_epochs``: whole ``Trainer.train_epoch`` calls.

Set-up makes the run's graph and features from the seed, builds the port's
dataset (BFS-relabelled), ``Trainer`` and ``init_state(seed)``, and runs
epoch 1 as the warm-up (its first step eager, its second captured, the rest
replayed), recording what its first ``ref_steps`` steps produced: each loss,
Adam's first moment after step 1 (0.1 times the first gradient) and the
parameters before step 1 and after the last of them.  Each timed unit is the
next epoch, all of it: negatives, the window-table refresh, each batch's
host preparation, the replayed steps and the epoch's one loss read.  The
check runs the configuration's reference over the same steps, and holds
what the window's last epoch derived (its last step's arguments, the seed
of its draws and the window tables the step reads, read once the window
has closed) against the reference's derivation of that epoch.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict

from harness import compare, core, graphgen, program


class Cell:
    window_metric = "train_links_per_s"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: str):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.limits = traffic["limits"]
        self.ref_steps = int(traffic["ref_steps"])
        self.failed = 0

    def setup(self) -> Dict[str, float]:
        from ocn_tpu_torch.train.loop import Trainer

        t0 = time.perf_counter()
        self.data = graphgen.make_graph(self.cfg["graph"], self.seed, self.device)
        self.stats = graphgen.work_stats(self.data, self.cfg["model"])
        t1 = time.perf_counter()
        pcfg = program.program_config(self.cfg)
        ds = program.dataset(self.data, pcfg.dataset, pcfg.use_valedges_as_input)
        self.tr = Trainer(pcfg, ds, device=self.device)
        self.state = self.tr.init_state(self.seed)
        t2 = time.perf_counter()
        self.rng = graphgen.train_rng(self.seed)
        self.rec = _Recorder(self.tr, self.ref_steps)
        self.tr.train_step = self.rec
        self.state, loss = self.tr.train_epoch(self.state, self.rng, 1)
        self.epoch = 2
        self.links_per_epoch = (self.stats["steps_per_epoch"] * 2 * self.stats["batch"])
        core.sync(self.device)
        t3 = time.perf_counter()
        return {"data_s": t1 - t0, "trainer_init_s": t2 - t1, "warm_s": t3 - t2,
                "warm_epoch_loss": loss}

    def unit(self) -> int:
        self.state, loss = self.tr.train_epoch(self.state, self.rng, self.epoch)
        self.epoch += 1
        if not math.isfinite(loss):
            self.failed += 1
        return self.links_per_epoch

    def counters(self) -> Dict[str, int]:
        return program.counters()

    def release(self) -> None:
        self.prog = self.rec.readings()
        self.last = self.rec.last_epoch()
        del self.tr.train_step
        del self.tr, self.state, self.rec
        core.release_cuda()

    def reference(self, tf32: bool = False) -> Dict:
        ref = core.import_reference(self.cfg["name"])
        return ref.train(self.cfg, self.data, self.seed, self.ref_steps,
                         self.device, tf32=tf32, epochs=self.epoch - 1)

    def check(self) -> Dict[str, Dict]:
        t0 = time.perf_counter()
        ref = self.reference()
        nums, detail = compare.train_readings(self.prog, ref)
        nums.update(compare.epoch_numbers(self.last, ref["last_epoch"]))
        core.log(f"reference {time.perf_counter() - t0:.2f} s; epoch {self.epoch - 1}; "
                 f"numbers {json.dumps(nums)}; {json.dumps(detail)}")
        return {k: {"value": nums[k], "limit": lim} for k, lim in self.limits.items()}


class _Recorder:
    """Trainer.train_step, recording its first ``steps`` calls, and holding
    the arguments of the latest call and the window tables of the first
    (the step program's buffers for them) for ``last_epoch``."""

    def __init__(self, tr, steps: int):
        self.fn = tr.train_step
        self.steps = steps
        self.calls = 0
        self.losses = []
        self.p0 = self.m1 = self.p_last = None
        self.tables = self.args = None

    def __call__(self, state, pos, neg, mp, gen, inv_p=None, inv_n=None):
        self.args = (pos, neg, mp, gen, inv_p, inv_n)
        if self.calls >= self.steps:
            self.calls += 1
            return self.fn(state, pos, neg, mp, gen, inv_p, inv_n)
        params = program.named_parameters(state)
        if self.calls == 0:
            self.p0 = {k: v.detach().clone() for k, v in params.items()}
            self.tables = _tables(mp)
        state, loss = self.fn(state, pos, neg, mp, gen, inv_p, inv_n)
        self.losses.append(loss.detach().clone())
        if self.calls == 0:
            self.m1 = {k: state.opt.state[v]["exp_avg"].detach().clone()
                       for k, v in params.items()}
        if self.calls == self.steps - 1:
            self.p_last = {k: v.detach().clone() for k, v in params.items()}
        self.calls += 1
        return state, loss

    def readings(self) -> Dict:
        if self.calls < self.steps:
            raise RuntimeError(f"the warm-up epoch ran {self.calls} steps, "
                               f"{self.steps} are compared")
        return {"losses": [float(x) for x in self.losses],
                "grads1": {k: (v / 0.1).cpu() for k, v in self.m1.items()},
                "p0": {k: v.cpu() for k, v in self.p0.items()},
                "p_last": {k: v.cpu() for k, v in self.p_last.items()}}

    def last_epoch(self) -> Dict:
        """The latest step's arguments on the host, the seed of its
        generator, and every distinct set of window tables the step reads:
        the first call's (which the step program keeps as its buffers) and
        the latest call's, where they are other tensors."""
        pos, neg, mp, gen, inv_p, inv_n = self.args
        last = _tables(mp)
        sets = [self.tables]
        if any(self.tables.get(k) is not t for k, t in last.items()):
            sets.append(last)
        host = lambda t: None if t is None else t.detach().cpu().numpy()  # noqa: E731
        return {"pos": host(pos), "neg": host(neg), "inv_p": host(inv_p),
                "inv_n": host(inv_n),
                "mask": host(mp["csr"] if isinstance(mp, dict) else mp),
                "seed": int(gen.initial_seed()),
                "tables": [{k: host(t) for k, t in s.items()} for s in sets if s]}


def _tables(mp) -> Dict:
    """The window tables and offsets among a step's mask positions."""
    if not isinstance(mp, dict):
        return {}
    return {k: mp[k] for k in ("ell1", "off1", "ell2", "off2") if k in mp}

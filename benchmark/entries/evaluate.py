"""Entry ``evaluate``: whole ``Trainer.evaluate`` calls (Hits@20/50/100 of
the train, valid and test positives against the valid and test negatives,
the test split re-encoded on the train+valid graph).

Set-up makes the run's graph and features from the seed, builds the port's
dataset (BFS-relabelled), ``Trainer`` and ``init_state(seed)``, builds the
window tables of epoch 1 (what the first training epoch would build) and
runs one evaluate as the warm-up.  Each timed unit is one evaluate.  Every
split's scores of every call are kept (``Trainer._score_split``'s answers):
the check holds each call's scores equal to the first call's, and the first
call's, every score of every split, against the configuration's reference.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from harness import compare, core, graphgen, program

SPLITS = ("train", "valid", "valid_neg", "test", "test_neg")


class Cell:
    window_metric = "eval_links_per_s"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: str):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.limits = traffic["limits"]
        self.calls: List[List[np.ndarray]] = []
        self.failed = 0

    def setup(self) -> Dict[str, float]:
        from ocn_tpu_torch.train.loop import Trainer, epoch_ell_rng

        t0 = time.perf_counter()
        self.data = graphgen.make_graph(self.cfg["graph"], self.seed, self.device)
        self.stats = graphgen.work_stats(self.data, self.cfg["model"])
        t1 = time.perf_counter()
        pcfg = program.program_config(self.cfg)
        ds = program.dataset(self.data, pcfg.dataset, pcfg.use_valedges_as_input)
        self.tr = Trainer(pcfg, ds, device=self.device)
        self.state = self.tr.init_state(self.seed)
        if self.tr._use_ell:
            self.tr._refresh_ell(epoch_ell_rng(1))
        t2 = time.perf_counter()
        score_split = self.tr._score_split

        def recording(*args, **kw):
            out = score_split(*args, **kw)
            self.calls[-1].append(out)
            return out

        self.tr._score_split = recording
        self.links = sum(s["links"] for s in self.stats["eval_splits"].values())
        self.calls.append([])
        self.tr.evaluate(self.state)
        t3 = time.perf_counter()
        return {"data_s": t1 - t0, "trainer_init_s": t2 - t1, "warm_s": t3 - t2}

    def unit(self) -> int:
        self.calls.append([])
        self.tr.evaluate(self.state)
        return self.links

    def counters(self) -> Dict[str, int]:
        return program.counters()

    def release(self) -> None:
        del self.tr, self.state
        core.release_cuda()
        first = self.calls[0]
        if len(first) != len(SPLITS):
            raise RuntimeError(f"evaluate scored {len(first)} splits, {len(SPLITS)} expected")
        self.mismatch = sum(
            1 for c in self.calls[1:]
            if len(c) != len(first) or any(not np.array_equal(a, b) for a, b in zip(c, first)))
        self.prog = dict(zip(SPLITS, first))
        self.calls = []

    def reference(self, tf32: bool = False) -> Dict[str, np.ndarray]:
        ref = core.import_reference(self.cfg["name"])
        return ref.evaluate(self.cfg, self.data, self.seed, self.device, tf32=tf32)

    def check(self) -> Dict[str, Dict]:
        t0 = time.perf_counter()
        nums = {"score_gap": compare.eval_numbers(self.prog, self.reference()),
                "calls_unequal": float(self.mismatch)}
        core.log(f"reference {time.perf_counter() - t0:.2f} s")
        return {k: {"value": nums[k], "limit": lim} for k, lim in self.limits.items()}

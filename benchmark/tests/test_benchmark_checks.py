"""The check that decides ``correct``, driven through whole runs on the CPU
at a tiny size: the program agrees with the plain reference, and each fault
a cell can have, planted in the program underneath, comes out as not
correct.  The control (the reference in TF32 in the program's place) needs
the card: ``test_tf32_control_fails``."""
import json

import numpy as np
import pytest
import torch

import tiny
from harness import compare, core, graphgen

SEED = 2 ** 31 + 99
CELLS = ("ocn_collab_train", "ocnp_collab_train", "ocn_collab_eval")


def _run(cell, seconds=0.5, trace=False):
    wl = core.load_json("workloads", f"{cell}.json")
    return core.run(cell, SEED, seconds, trace, device="cpu", wl=wl,
                    cfg=tiny.config(wl["config"]))


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_the_reference(cell):
    out = _run(cell)
    assert out["correct"], json.dumps(out["checks"])
    assert list(out)[-1] == "checks" and out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS[:2])
def test_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    from ocn_tpu_torch.train import loop

    def frozen(self, state, pos, neg, mp, gen, inv_p=None, inv_n=None):
        loss = self.step_loss(state, pos, neg, mp, gen, inv_p, inv_n)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in state.opt.param_groups:
            for p in group["params"]:
                state.opt.state[p]["exp_avg"] = 0.1 * p.grad.detach().clone()
        return loss.detach()

    monkeypatch.setattr(loop.Trainer, "_step", frozen)
    out = _run(cell)
    assert not out["correct"] and out["checks"]["step_median_gap"]["value"] > \
        out["checks"]["step_median_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS[:2])
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from ocn_tpu_torch.train import loop

    orig = loop.Trainer._loss

    def half(self, pos, neg):
        return orig(self, pos[: pos.shape[0] // 2], neg[: neg.shape[0] // 2])

    monkeypatch.setattr(loop.Trainer, "_loss", half)
    out = _run(cell)
    assert not out["correct"]


class _HeldRng:
    """The run's train generator with one of its draws held at epoch 1's
    value from then on: the permutation, or the seed of the step's draws;
    each draw is still taken, so every other draw stays as it was."""

    def __init__(self, rng, held: str):
        self.rng, self.held, self.first = rng, held, None

    def _hold(self, kind, value):
        if kind != self.held:
            return value
        self.first = value if self.first is None else self.first
        return self.first

    def permutation(self, e):
        return self._hold("permutation", self.rng.permutation(e))

    def integers(self, *a, **kw):
        v = self.rng.integers(*a, **kw)
        return self._hold("seed", v) if a == (2 ** 31,) else v

    def __getattr__(self, name):
        return getattr(self.rng, name)


@pytest.mark.parametrize("fault,number", [("negatives_reused", "neg_unequal"),
                                          ("permutation_reused", "batch_unequal"),
                                          ("seed_reused", "seed_unequal"),
                                          ("tables_not_refreshed", "ell_unequal")])
def test_a_timed_epoch_derives_its_inputs_wrong(fault, number, monkeypatch):
    """The window's epochs are held against the reference's own derivation:
    epoch 1's negatives reused (their seed still drawn), its permutation
    reused, the step's generator reseeded with epoch 1's seed, or the window
    tables left as epoch 1 built them (what the replays read where a
    refresh rebinds tables that the step program never sees) each come out
    as not correct, on the number that reads that input."""
    from ocn_tpu_torch.sparse import build as B
    from ocn_tpu_torch.train import loop

    if fault == "negatives_reused":
        orig, held = B.negative_sampling, {}

        def reused(ei, n, num, rng=None):
            if "neg" in held:
                rng.integers(1, 2 ** 62)
                return held["neg"]
            held["neg"] = orig(ei, n, num, rng)
            return held["neg"]

        monkeypatch.setattr(B, "negative_sampling", reused)
    elif fault == "tables_not_refreshed":
        refresh = loop.Trainer._refresh_ell

        def once(self, rng):
            if self._ell is None:
                refresh(self, rng)

        monkeypatch.setattr(loop.Trainer, "_refresh_ell", once)
    else:
        train_rng = graphgen.train_rng
        monkeypatch.setattr(graphgen, "train_rng",
                            lambda seed: _HeldRng(train_rng(seed), fault.split("_")[0]))
    out = _run("ocn_collab_train")
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"], out["checks"]


def test_tables_rebound_and_copied_into_the_steps_buffers(monkeypatch):
    """A refresh that builds each epoch's tables in new tensors is sound
    where the step program copies them into the buffers its step reads:
    both the buffers and the latest tables are held, and agree."""
    from ocn_tpu_torch.train import loop

    refresh = loop.Trainer._refresh_ell

    def rebound(self, rng):
        self._ell = None
        refresh(self, rng)

    monkeypatch.setattr(loop.Trainer, "_refresh_ell", rebound)
    out = _run("ocn_collab_train")
    assert out["correct"], json.dumps(out["checks"])


@pytest.mark.parametrize("from_call", [0, 2])
def test_an_answer_altered_where_it_is_produced(from_call, monkeypatch):
    from ocn_tpu_torch.train import loop

    orig = loop.Trainer._score_batches
    calls = {"n": 0}

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        calls["n"] += 1
        if calls["n"] > 5 * from_call and out.size:
            out = out.copy()
            out[out.size // 2] += 0.5
        return out

    monkeypatch.setattr(loop.Trainer, "_score_batches", altered)
    out = _run("ocn_collab_eval")
    assert not out["correct"]
    key = "score_gap" if from_call == 0 else "calls_unequal"
    assert out["checks"][key]["value"] > out["checks"][key]["limit"]


def _collab_sized_down(cfg):
    """A configuration at its full widths on a graph of 40,000 nodes."""
    cfg["graph"] = {"n_nodes": 40000, "n_features": 128, "edges": 200000, "train": 180000,
                    "valid": 10000, "test": 10000, "neg_valid": 20000, "neg_test": 20000,
                    "zipf_exponent": 0.5}
    return cfg


def test_readings_of_the_reference_against_itself():
    """The reference against itself reads 0 on every number (its sums run
    in a fixed order); half of each batch left out of the loss reads far
    above that."""
    cfg = tiny.config("ocn_collab")
    data = graphgen.make_graph(cfg["graph"], SEED)
    ref = core.import_reference("ocn_collab")
    a = ref.train(cfg, data, SEED, 2, "cpu")
    b = ref.train(cfg, data, SEED, 2, "cpu")
    assert all(v == 0.0 for v in compare.train_readings(a, b)[0].values())
    half = ref.train(cfg, data, SEED, 2, "cpu", fault="half_batch")
    assert compare.train_readings(half, a)[0]["loss1_gap"] > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails(cell, card):
    """The reference with TF32 matmuls in the program's place fails the
    cell's limits, at full widths on a smaller graph."""
    wl = core.load_json("workloads", f"{cell}.json")
    cfg = _collab_sized_down(core.load_json("configs", f"{wl['config']}.json"))
    data = graphgen.make_graph(cfg["graph"], SEED)
    ref = core.import_reference(cfg["name"])
    lim = wl["traffic"]["limits"]
    if wl["entry"] == "train_epochs":
        base = ref.train(cfg, data, SEED, 3, card)
        low = ref.train(cfg, data, SEED, 3, card, tf32=True)
        nums = compare.train_readings(low, base)[0]
    else:
        nums = {"score_gap": compare.eval_numbers(
            ref.evaluate(cfg, data, SEED, card, tf32=True),
            ref.evaluate(cfg, data, SEED, card))}
    assert any(nums[k] > lim[k] for k in nums if k in lim), nums


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["ocn_collab", "ocnp_collab"])
def test_reference_agrees_with_itself_on_the_card(config, card):
    """Two runs of the reference on the card agree bit for bit: every
    gradient, the scalar leaves' too, and each step's loss."""
    cfg = _collab_sized_down(core.load_json("configs", f"{config}.json"))
    data = graphgen.make_graph(cfg["graph"], SEED)
    ref = core.import_reference(config)
    a = ref.train(cfg, data, SEED, 3, card)
    b = ref.train(cfg, data, SEED, 3, card)
    nums = compare.train_readings(a, b)[0]
    assert all(v == 0.0 for v in nums.values()), nums

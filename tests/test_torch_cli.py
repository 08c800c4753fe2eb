"""Port parity: the CLI's run-level features against the JAX package's:
the MetricLogger (utils/logging.py), the HPO driver (train/hpo.py), and
cli.run with checkpoints, resume, embedding export and a profile trace,
on the CPU at a small size.  The runs block the tensorboard package, as
on a machine without it (the logger then writes its JSONL alone)."""
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest

from ocn_tpu.config import Config as JConfig
from ocn_tpu.train import hpo as jhpo
from ocn_tpu.utils.logging import MetricLogger as JLogger
from ocn_tpu_torch import cli as tcli
from ocn_tpu_torch.config import Config as TConfig
from ocn_tpu_torch.train import hpo as thpo
from ocn_tpu_torch.train.checkpoint import load_state
from ocn_tpu_torch.train.loop import Trainer as TTrainer
from ocn_tpu_torch.utils.logging import MetricLogger as TLogger
from torch_parity import one_thread  # noqa: F401 (autouse: one intra-op thread)

CORA = ["--dataset", "Cora", "--predictor", "cn5", "--model", "gcn",
        "--mplayers", "1", "--hiddim", "16", "--batch_size", "128",
        "--testbs", "256", "--runs", "1", "--maskinput", "--pad_deg", "16",
        "--pad_deg2", "16", "--synthetic_scale", "0.1", "--no-ell_tables",
        "--k_small", "0", "--platform", "cpu"]


@pytest.fixture
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _log(logger):
    logger.text("hyperparams", json.dumps({"gnnlr": 0.01}))
    logger.scalars("Hits@20_0", {"trn": 0.5, "val": 0.25, "tst": 0.125}, 1)
    logger.scalars("Hits@20_0", {"trn": 0.75, "val": 0.5, "tst": 0.25}, 2)


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_metrics_jsonl_equals_jax(tmp_path, no_tensorboard):
    _log(JLogger(str(tmp_path / "j")))
    logger = TLogger(str(tmp_path / "t"))
    _log(logger)
    logger.close()
    want, got = _records(tmp_path / "j"), _records(tmp_path / "t")
    assert all(isinstance(r.pop("t"), float) for r in want + got)
    assert got == want and len(got) == 3


def test_tensorboard_gets_the_same_calls(tmp_path, monkeypatch):
    calls = []

    class Writer:
        def __init__(self, logdir):
            calls.append(("init", os.path.basename(logdir)))

        def add_scalars(self, *args):
            calls.append(("scalars",) + args)

        def add_text(self, *args):
            calls.append(("text",) + args)

        def close(self):
            pass

    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    _log(JLogger(str(tmp_path / "run")))
    want, calls[:] = list(calls), []
    _log(TLogger(str(tmp_path / "run2")))
    assert calls[1:] == want[1:] and len(calls) == 4


def test_sample_equals_jax():
    space = {**jhpo.DEFAULT_SPACE, "alpha": ("uniform", (0.5, 2.0))}
    assert thpo.DEFAULT_SPACE == jhpo.DEFAULT_SPACE
    for seed in range(4):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(8):
            assert thpo.sample(space, tr) == jhpo.sample(space, jr)
    with pytest.raises(ValueError, match="unknown sampler kind"):
        thpo.sample({"x": ("normal", (0, 1))}, np.random.default_rng(0))


def _objective():
    """A stub trial: the second fails, the third diverges (NaN val), the
    others score by their sampled gnndp."""
    trial = [0]

    def objective(cfg):
        trial[0] += 1
        if trial[0] == 2:
            raise RuntimeError("out of memory")
        v = float("nan") if trial[0] == 3 else 1.0 - abs(cfg.gnndp - 0.25)
        return {"val_mean": v, "val_std": 0.0, "tst_mean": v / 2, "tst_std": 0.0}
    return objective


def test_random_search_writes_the_jax_records(tmp_path, capsys):
    jbest = jhpo.random_search(JConfig(dataset="Cora", predictor="cn5"), 6,
                               seed=3, out_dir=str(tmp_path / "j"),
                               objective=_objective())
    want_out = capsys.readouterr().out
    tbest = thpo.random_search(TConfig(dataset="Cora", predictor="cn5"), 6,
                               seed=3, out_dir=str(tmp_path / "t"),
                               objective=_objective())
    assert capsys.readouterr().out == want_out
    with open(tmp_path / "j" / "hpo_Cora_cn5.jsonl") as f:
        want = f.read()
    with open(tmp_path / "t" / "hpo_Cora_cn5.jsonl") as f:
        got = f.read()
    assert got == want and tbest == jbest
    recs = [json.loads(line) for line in got.splitlines()]
    assert len(recs) == 6 and "error" in recs[1] and np.isnan(recs[2]["val_mean"])
    assert np.isfinite(tbest["val_mean"])


def test_hpo_main_parses_as_jax(monkeypatch, tmp_path):
    argv = ["--trials", "3", "--hpo_seed", "2", "--hpo_out", str(tmp_path),
            "--space", '{"gnnlr": ["log", [1e-4, 1e-2]]}', *CORA, "--epochs", "1"]
    seen = {}

    def capture(name):
        def search(base, trials, space=None, seed=0, out_dir="rec"):
            seen[name] = (dataclasses.asdict(base), trials, space, seed, out_dir)
        return search

    monkeypatch.setattr(jhpo, "random_search", capture("jax"))
    monkeypatch.setattr(thpo, "random_search", capture("port"))
    jhpo.main(argv)
    thpo.main(argv)
    assert seen["port"] == seen["jax"]
    assert seen["port"][1:] == (3, {"gnnlr": ("log", (1e-4, 1e-2))}, 2, str(tmp_path))


def test_run_saves_resumes_exports_and_profiles(tmp_path, monkeypatch, capsys,
                                                no_tensorboard):
    """savemod + checkpoint_dir, save_gemb and profile_dir over 2 epochs,
    then a loadmod run: the checkpoint of the last new best, the hidden
    states of that state under gemb/, a Chrome trace of epoch 1, both
    epochs in rec/gcn_cn5/metrics.jsonl, and the resume from that step."""
    monkeypatch.chdir(tmp_path)
    cfg = tcli.parseargs([*CORA, "--epochs", "2", "--savemod", "--checkpoint_dir",
                          "ckpt", "--save_gemb", "--profile_dir", "prof"])
    tcli.run(cfg)
    steps = sorted(int(d) for d in os.listdir("ckpt"))
    assert steps and set(steps) <= {1, 2}
    h = np.load(os.path.join("gemb", "Cora_gcn_cn5_16.npy"))
    tr = TTrainer(cfg, tcli.run_dataset(cfg), device="cpu")
    state, step = load_state("ckpt", tr.init_state(cfg.seed))
    assert step == steps[-1]
    np.testing.assert_array_equal(tr.encode(state).numpy(), h)
    with open(os.path.join("prof", "trace.json")) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)
    records = _records(os.path.join("rec", "gcn_cn5"))
    assert records[0]["text"] == json.dumps(dataclasses.asdict(cfg))
    scalars = [(r["tag"], r["step"]) for r in records[1:]]
    assert sorted(scalars) == sorted((f"Hits@{k}_0", e) for k in (20, 50, 100)
                                     for e in (1, 2))
    capsys.readouterr()
    tcli.run(dataclasses.replace(cfg, loadmod=True, savemod=False,
                                 save_gemb=False, profile_dir="", epochs=1))
    assert f"resumed from ckpt step {steps[-1]}" in capsys.readouterr().out


def test_savex_exports_the_embedding_table(tmp_path, monkeypatch, no_tensorboard):
    """ppa's preset takes integer features through an Embedding, whose
    table savex writes at each new best validation."""
    monkeypatch.chdir(tmp_path)
    cfg = tcli.parseargs(["--dataset", "ppa", "--predictor", "cn5", "--preset",
                          "--epochs", "3", "--runs", "1", "--hiddim", "16",
                          "--synthetic_scale", "0.0005", "--batch_size", "256",
                          "--testbs", "512", "--linkbatchsize", "64",
                          "--savex", "--platform", "cpu"])
    tcli.run(cfg)
    table = np.load(os.path.join("gemb", "ppa_gcn_cn5_16_0.npy"))
    assert table.shape[1] == 16 and table.dtype == np.float32
    assert not os.path.exists(os.path.join("gemb", "ppa_gcn_cn5_16.npy"))

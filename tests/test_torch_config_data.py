"""Port parity, host layer: Config/presets, datasets, CSR construction,
edge2pos, A^2, negatives, the Graph container, losses, metrics, the CLI
flag surface, and the package rules (no JAX imports, CUDA by default)."""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocn_tpu import config as jcfg
from ocn_tpu.data import loaders as jld
from ocn_tpu.sparse import build as jb
from ocn_tpu.sparse import csr as jcsr
from ocn_tpu.train import losses as jloss
from ocn_tpu.train import metrics as jmet
from ocn_tpu_torch import cli as tcli
from ocn_tpu_torch import config as tcfg
from ocn_tpu_torch.data import loaders as tld
from ocn_tpu_torch.sparse import build as tb
from ocn_tpu_torch.sparse import csr as tcsr
from ocn_tpu_torch.train import losses as tloss
from ocn_tpu_torch.train import metrics as tmet
from ocn_tpu_torch.train.loop import Trainer
from ocn_tpu_torch.utils import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("overlay", [True, False])
@pytest.mark.parametrize("key", sorted(jcfg._README_PRESETS))
def test_presets_match_reference(key, overlay):
    want = dataclasses.asdict(jcfg.presets(*key, tpu_overlay=overlay))
    got = dataclasses.asdict(tcfg.presets(*key, tpu_overlay=overlay))
    assert got == want


def test_config_defaults_and_fields_match():
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(jcfg.Config())
    assert tcfg.Config().predictor_kwargs() == jcfg.Config().predictor_kwargs()


@pytest.mark.parametrize("field,value", [
    ("cndeg", 32), ("predictor", "cn2"), ("predictor", "cn3"), ("predictor", "cn4"),
    ("dp_devices", 4), ("graph_sharding", "node"),
])
def test_unported_fields_raise(field, value):
    cfg = tcfg.Config(**{field: value})
    with pytest.raises(NotImplementedError, match=f"Config.{field}"):
        tcfg.require_supported(cfg)


@pytest.mark.parametrize("field,value", [
    ("ell_tables", True), ("k_small", 16), ("window_table", True),
    ("frame_group", 8), ("dtype", "bfloat16"), ("hoist_frames", True),
    ("predictor", "cn1"), ("predictor", "cn5"), ("predictor", "cn6"),
    ("predictor", "cn7"), ("predictor", "cn8"), ("predictor", "cn9"),
    ("two_hop_mode", "sddmm"), ("encoder_stack", "ho"),
])
def test_ported_fields_are_accepted(field, value):
    tcfg.require_supported(tcfg.Config(**{field: value}))


@pytest.mark.parametrize("key", sorted(jcfg._README_PRESETS))
def test_every_preset_is_supported(key):
    tcfg.require_supported(tcfg.presets(*key))


@pytest.mark.parametrize("field,value", [
    ("two_hop_mode", "spgemm"), ("encoder_stack", "pyg"), ("dtype", "float16"),
])
def test_unknown_values_are_refused(field, value):
    with pytest.raises(ValueError, match=f"Config.{field}"):
        tcfg.require_supported(tcfg.Config(**{field: value}))


def test_collab_preset_needs_the_knobs_off():
    # presets("collab", "cn5") (ELL tables, k_small=16) runs as it is, with
    # the window table, at bench.py's frame_group 8 and bfloat16, and with
    # hoisted frames; so do the OCNP presets; the incomplete family raises
    tcfg.require_supported(tcfg.presets("collab", "cn5"))
    tcfg.require_supported(tcfg.presets("collab", "cn5", window_table=True))
    tcfg.require_supported(tcfg.presets("collab", "cn5", frame_group=8,
                                        dtype="bfloat16"))
    tcfg.require_supported(tcfg.presets("collab", "cn5", frame_group=8,
                                        hoist_frames=True))
    for ds in ("Cora", "Citeseer", "Pubmed", "collab"):
        tcfg.require_supported(tcfg.presets(ds, "cn7"))
    with pytest.raises(NotImplementedError, match="Config.predictor"):
        tcfg.require_supported(tcfg.presets("collab", "cn2"))


def _assert_dataset_equal(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.edge_index, b.edge_index)
    assert (a.n_nodes, a.max_x) == (b.n_nodes, b.max_x)
    assert a.split_edge.keys() == b.split_edge.keys()
    for part in a.split_edge:
        assert a.split_edge[part].keys() == b.split_edge[part].keys()
        for k in a.split_edge[part]:
            np.testing.assert_array_equal(a.split_edge[part][k], b.split_edge[part][k])


@pytest.mark.parametrize("name,scale", [("Cora", 0.3), ("ddi", 0.05), ("collab", 0.002)])
def test_synthetic_dataset_and_bfs_match(name, scale):
    assert tnative.loaded()
    a = jld.synthetic_dataset(name, seed=3, scale=scale)
    b = tld.synthetic_dataset(name, seed=3, scale=scale)
    _assert_dataset_equal(a, b)
    _assert_dataset_equal(a.reorder_bfs(), b.reorder_bfs())


def test_sbm_and_npz_roundtrip(tmp_path):
    a = jld.sbm_dataset(n=300, seed=1)
    b = tld.sbm_dataset(n=300, seed=1)
    _assert_dataset_equal(a, b)
    path = str(tmp_path / "sbm.npz")
    tld.save_npz(path, b)
    _assert_dataset_equal(jld.load_npz(path, "sbm"), tld.load_npz(path, "sbm"))


def test_loaddataset_valedges_match():
    a = jld.loaddataset("Cora", use_valedges_as_input=True, seed=2, synthetic_scale=0.2,
                        root="/nonexistent")
    b = tld.loaddataset("Cora", use_valedges_as_input=True, seed=2, synthetic_scale=0.2,
                        root="/nonexistent")
    _assert_dataset_equal(a, b)
    np.testing.assert_array_equal(a.full_edge_index, b.full_edge_index)


def _host_graph(seed=0, n=400):
    ds = tld.synthetic_dataset("Cora", seed=seed, scale=n / 2708)
    ip, col = tb.csr_from_edge_index(ds.edge_index, ds.n_nodes)
    return ds, ip, col


def test_csr_edge2pos_adj2_negatives_match():
    ds, ip, col = _host_graph()
    jip, jcol = jb.csr_from_edge_index(ds.edge_index, ds.n_nodes)
    np.testing.assert_array_equal(ip, jip)
    np.testing.assert_array_equal(col, jcol)
    edges = ds.split_edge["train"]["edge"].T
    np.testing.assert_array_equal(tb.edge_to_nnz_positions(ip, col, edges),
                                  jb.edge_to_nnz_positions(ip, col, edges))
    for cap in (1024, 8):
        for x, y in zip(tb.adj2_csr(ip, col, ds.n_nodes, cap),
                        jb.adj2_csr(ip, col, ds.n_nodes, cap)):
            np.testing.assert_array_equal(x, y)
    got = tb.negative_sampling(ds.edge_index, ds.n_nodes, 500, np.random.default_rng(5))
    want = jb.negative_sampling(ds.edge_index, ds.n_nodes, 500, np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)


def test_numpy_fallbacks_match_native(monkeypatch):
    ds, ip, col = _host_graph(seed=1, n=150)
    edges = ds.split_edge["train"]["edge"].T
    nat = (tb.csr_from_edge_index(ds.edge_index, ds.n_nodes),
           tb.edge_to_nnz_positions(ip, col, edges),
           tb.adj2_csr(ip, col, ds.n_nodes, 16),
           tb.spgemm_csr(ip, col, None, ip, col, None, ds.n_nodes, 16))
    monkeypatch.setattr(tnative, "load", lambda: None)
    fb = (tb.csr_from_edge_index(ds.edge_index, ds.n_nodes),
          tb.edge_to_nnz_positions(ip, col, edges),
          tb.adj2_csr(ip, col, ds.n_nodes, 16),
          tb.spgemm_csr(ip, col, None, ip, col, None, ds.n_nodes, 16))
    for a, b in zip(nat, fb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("gather_only", [False, True])
def test_graph_from_numpy_matches(gather_only):
    ds, ip, col = _host_graph(seed=2)
    ip2, col2, val2 = tb.adj2_csr(ip, col, ds.n_nodes, 64)
    for args in ((ip, col, ds.n_nodes), (ip2, col2, ds.n_nodes, val2)):
        jg = jcsr.graph_from_numpy(*args, gather_only=gather_only)
        tg = tcsr.graph_from_numpy(*args, gather_only=gather_only)
        assert (tg.n_nodes, tg.col_bits, tg.nnz) == (jg.n_nodes, jg.col_bits, jg.nnz)
        for f in ("indptr", "col", "row", "val", "deg", "tpos", "packed"):
            a, b = getattr(jg, f), getattr(tg, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)


def test_gather_only_keeps_col_and_val_when_counts_do_not_pack():
    """A^2 path counts past 2^(31 - col_bits) do not pack: the gather-only
    graph then keeps indptr/deg/col/val (no row, no transpose permutation),
    equal to the JAX package's full layout in those four, and its window
    gathers read the same neighbor lists."""
    from ocn_tpu.ops import frame as jf
    from ocn_tpu_torch.ops import frame as tf

    ds, ip, col = _host_graph(seed=2)
    ip2, col2, val2 = tb.adj2_csr(ip, col, ds.n_nodes, 64)
    val2 = val2 * 1.0e6  # counts of a huge graph: col_bits 9 leaves 22 bits
    jg = jcsr.graph_from_numpy(ip2, col2, ds.n_nodes, val2, gather_only=True)
    tg = tcsr.graph_from_numpy(ip2, col2, ds.n_nodes, val2, gather_only=True)
    assert jg.packed is None and tg.packed is None
    assert tg.row is None and tg.tpos is None and jg.row is not None
    for f in ("indptr", "col", "val", "deg"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)),
                                      getattr(tg, f).numpy(), err_msg=f)
    nodes = np.arange(0, ds.n_nodes, 7)
    a = jf.gather_neighbors(jg, jnp.asarray(nodes), 16)
    b = tf.gather_neighbors(tg, torch.as_tensor(nodes), 16)
    np.testing.assert_array_equal(np.asarray(a.ids), b.ids.numpy())
    np.testing.assert_array_equal(np.asarray(a.w), b.w.numpy())


def test_graph_edits_match():
    ds, ip, col = _host_graph(seed=3)
    jg = jcsr.graph_from_numpy(ip, col, ds.n_nodes)
    tg = tcsr.graph_from_numpy(ip, col, ds.n_nodes)
    pos = np.random.default_rng(0).integers(0, int(ip[-1]), size=40)
    jm = jg.mask_edges(jnp.asarray(pos))
    tm = tg.mask_edges(torch.as_tensor(pos))
    np.testing.assert_array_equal(np.asarray(jm.val), tm.val.numpy())
    np.testing.assert_array_equal(np.asarray(jm.packed), tm.packed.numpy())
    np.testing.assert_allclose(np.asarray(jm.value_rowsum()), tm.value_rowsum().numpy())
    # DropAdj: keep-rate and rescaling (random streams differ by design)
    dropped = tg.drop_edges(0.25, torch.Generator().manual_seed(0))
    v = dropped.val[: int(ip[-1])]
    assert dropped.packed is None
    assert set(np.unique(v.numpy())) <= {0.0, np.float32(1 / 0.75)}
    assert abs((v != 0).float().mean().item() - 0.75) < 0.05


@pytest.mark.parametrize("name", sorted(tloss.LOSSES))
def test_losses_match(name):
    rng = np.random.default_rng(0)
    pos = rng.standard_normal(64).astype(np.float32)
    neg = rng.standard_normal(64).astype(np.float32)
    kw = dict(num_neg=1, weight=0.7, margin=0.4)
    want = float(jloss.LOSSES[name](jnp.asarray(pos), jnp.asarray(neg), **kw))
    got = float(tloss.LOSSES[name](torch.as_tensor(pos), torch.as_tensor(neg), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_metrics_match():
    rng = np.random.default_rng(1)
    pos, neg = rng.standard_normal(300), rng.standard_normal(500)
    for k in (20, 50, 100):
        assert tmet.hits_at_k(pos, neg, k) == jmet.hits_at_k(pos, neg, k)
    negm = rng.standard_normal((300, 20))
    assert tmet.mrr(pos, negm) == jmet.mrr(pos, negm)


def test_cli_flag_surface():
    cfg = tcli.parseargs(["--dataset", "collab", "--predictor", "cn5", "--preset",
                          "--ell_tables", "false", "--k_small", "0", "--no-ln",
                          "--jk", "--epochs", "3"])
    want = dataclasses.asdict(jcfg.presets("collab", "cn5", ell_tables=False,
                                           k_small=0, ln=False, jk=True, epochs=3))
    assert dataclasses.asdict(cfg) == want
    tcfg.require_supported(cfg)
    assert tcli.parseargs([]) == tcfg.Config()


_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ocn_tpu"}


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_reference_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ocn_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = {(os.path.relpath(f, REPO), m) for f in files for m in _imported_roots(f)
           if m in _FORBIDDEN}  # exact top-level names: ocn_tpu_torch is allowed
    assert not bad, bad
    roots = {m for f in files for m in _imported_roots(f)}
    assert "ocn_tpu_torch" in roots and "ocn_tpu" not in roots


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default-device run is valid here")
    ds = tld.synthetic_dataset("Cora", seed=0, scale=0.05)
    cfg = tcfg.Config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, ds)
    Trainer(cfg, ds, device="cpu")

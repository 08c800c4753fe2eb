"""chip_smoke.py's multi-device phases rehearsed on the CPU at a tiny size:
mesh_slice on four gloo ranks and node_sharded_slice on two, each with its
reference case, spawned as on the card but on the CPU (chip_rehearsal.py's
``on_cpu``; the ranks count membership's plain calls in place of the
kernel's launches).  mesh_slice's losses are held against bench_slice's
from the same program on one device, as the card run holds them."""
import json

import numpy as np

import chip_smoke
from chip_rehearsal import TINY, on_cpu, one_thread  # noqa: F401 (fixtures)
from ocn_tpu_torch.data.loaders import synthetic_dataset


def test_rank_phases_on_cpu(on_cpu, capsys):
    ds = synthetic_dataset("collab", seed=0, scale=0.01).reorder_bfs()
    _, _, bench_losses = chip_smoke.phase_bench_slice(ds, **TINY)
    capsys.readouterr()
    launches = chip_smoke.phase_ranks(ds, bench_losses,
                                      chip_smoke.reference_dataset("Cora"), **TINY)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == [
        "mesh_slice", "node_sharded_slice", "reference_ranks"]
    mesh, node, ref = lines
    assert mesh["ranks"] == 4 and node["ranks"] == 2
    assert mesh["backend"] == node["backend"] == "gloo"
    np.testing.assert_allclose(mesh["losses"], bench_losses, rtol=1e-4)
    # every rank scores a dp share of each of a step's two frame groups (the
    # small and the big body), two lookups a group, as bench_slice does
    assert mesh["bench_slice_losses"] == bench_losses
    for r in mesh["per_rank"]:
        assert r["membership_launches_per_step"] == [2 * 2] * 3
        assert r["comm_train"]["calls"]["all_reduce"] > 0
    assert mesh["row_parallel"] == ["xcn1lin.dense.0.weight",
                                    "xcn2lin.dense.0.weight",
                                    "xijlin.dense.0.weight"]
    # node-sharded: each rank its own 4 + 4 chunks, two lookups a chunk
    for r in node["per_rank"]:
        assert r["membership_launches_per_step"] == [2 * 8] * 3
        assert r["rescore_max_abs_err"] == 0.0
        assert r["graph_bytes_device"] < node["graph_bytes_replicated"]
    assert 0 < node["halo_fraction"] <= 1
    assert launches == {"mesh_slice": mesh["membership_launches"],
                        "node_sharded_slice": node["membership_launches"]}
    assert set(ref) == {"phase", "mesh_loss_cpu", "mesh_hits50_cpu",
                        "node_sharded_loss_cpu", "node_sharded_hits50_cpu"}
    assert np.isfinite(ref["mesh_loss_cpu"] + ref["node_sharded_loss_cpu"]).all()

"""The dp x tp mesh step across the port's programs: every predictor
family, both encoder stacks, both two-hop modes and the layout options,
each at dp 2 x tp 2 on four gloo ranks on the CPU against the port's own
single-device step (held against JAX in the port's other parity tests,
and at dp 2 x tp 2 for cn5 in tests/test_torch_dist.py).

Dropout is on (gnndp, predp and, for the family, preedp): the mesh step
draws the single-device step's masks (parallel/shard.py), so even the
random streams must agree.  Two steps and an evaluate from
init_state(0); losses at rtol 1e-5 (the same sums in another order over
the ranks) and Hits@K at atol 1e-9.  The ranks are spawned once for the
module (tests/torch_dist.py)."""
import numpy as np
import pytest

import torch_dist as TD
from ocn_tpu_torch.parallel.launch import launch
from torch_parity import one_thread  # noqa: F401 (autouse)

BASE = dict(dataset="Cora", predictor="cn5", model="puregcn", mplayers=2,
            hiddim=32, batch_size=256, testbs=256, maskinput=True, pad_deg=16,
            pad_deg2=16, linkbatchsize=32, gnndp=0.1, xdp=0.1, tdp=0.1,
            gnnedp=0.1, predp=0.2, preedp=0.0, ell_tables=False, gnnlr=1e-3,
            prelr=1e-3, lnnn=True, use_xlin=True, tailact=True)
SPLIT = dict(ell_tables=True, k_small=4, small_frac=0.5, small_frac_neg=0.5)
CASES = {
    "grouped_bf16_tables_dualk": dict(SPLIT, frame_group=2, dtype="bfloat16"),
    "window_table": dict(ell_tables=True, window_table=True),
    "hoisted_cndeg": dict(hoist_frames=True, cndeg=8),
    "cn1": dict(predictor="cn1"),
    "cn6_tables_dualk": dict(SPLIT, predictor="cn6"),
    "cn7": dict(predictor="cn7"),
    "cn9": dict(predictor="cn9", polyfirst=3),
    "ho_sddmm": dict(encoder_stack="ho", model="gcn", cn2_counts=True,
                     two_hop_mode="sddmm", exact_two_hop=True),
    "cn2_lane_drop": dict(predictor="cn2", rec_k=8, trndeg=8, tstdeg=8, preedp=0.2),
    "cn3_tables_dualk": dict(SPLIT, predictor="cn3", rec_k=8, trndeg=8, tstdeg=8),
    "cn2_depth2_learnpt": dict(predictor="cn2", depth=2, rec_k=8, trndeg=4,
                               tstdeg=4, learnpt=True),
}


@pytest.fixture(scope="module")
def ranks():
    cases = [(name, TD.mesh_vs_single_case, (dict(BASE, **kw), 2, 2))
             for name, kw in CASES.items()]
    return launch(TD.run_cases, 4, cases, device="cpu", threads=1)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_equals_single_device(ranks, name):
    tr, state = TD.trainer(dict(BASE, **CASES[name]), TD.cora())
    if tr._use_ell:
        tr._refresh_ell(np.random.default_rng(7))
    losses = TD.steps(tr, state, TD.mesh_batches(tr))
    want = tr.evaluate(state)
    assert np.isfinite(losses).all() and len(set(losses)) == 2
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for key in want:
            np.testing.assert_allclose(got["hits"][key], want[key], atol=1e-9,
                                       err_msg=key)

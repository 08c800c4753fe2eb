"""chip_smoke.py's reference cases of the "ho" stack (ppa, citation2, spd) and the
incomplete family (cn2, cn3, cn2 at depth 2, cn2 with the learnable pt), each rehearsed
on the CPU (tests/chip_rehearsal.py): the case runs once there, with every
check the card run makes apart from the card-against-CPU comparison."""
import numpy as np
import pytest

import chip_smoke
from chip_rehearsal import STACK_CASES, on_cpu, one_thread  # noqa: F401 (fixtures)


@pytest.mark.parametrize("name", STACK_CASES)
def test_reference_phase_on_cpu(on_cpu, name):
    keys = chip_smoke.run_reference_case(name)
    prefix = "" if name == "plain" else f"{name}_"
    losses = keys[f"{prefix}loss_cpu"]
    assert keys[f"{prefix}loss_cuda"] == losses
    assert len(losses) == chip_smoke.reference_cases()[name][1]
    assert np.isfinite(losses).all()
    metric = next(k for k in keys if k.endswith(("hits50_cpu", "mrr_cpu")))
    assert np.all((np.asarray(keys[metric]) >= 0) & (np.asarray(keys[metric]) <= 1))

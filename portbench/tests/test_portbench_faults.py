"""``correct`` comes out false when the timed path is broken underneath: each
fault a cell can have, planted where the program produces its answer, on the
CPU at small sizes with the cells' own limits."""
import pytest

from portbench.tests.helpers import small_run

FAULTS = [
    ("starcoder2-7b.decode-b16", "answer"),
    ("starcoder2-7b.decode-b16", "half_batch"),
    ("starcoder2-7b.decode-b16", "stale_state"),
    ("starcoder2-7b.prefill-int8", "answer"),
]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(workload, fault):
    out = small_run(workload, faults=(fault,))
    assert not out["correct"], out["checks"]

"""A run with the timed path broken underneath comes out not correct, and
a sound one correct: every cell, every fault it can have (``faults.py``),
on the CPU at a small size."""

import pytest

from vqabench import faults
from vqabench.tests.conftest import rehearse

CASES = [(cell, None) for cell in faults.BY_CELL] + \
        [(cell, f) for cell, fs in faults.BY_CELL.items() for f in fs]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_correct_comes_out_false_for_each_fault(cell, fault, two_threads):
    if fault is None:
        result, lines = rehearse(cell)
        assert result["correct"], lines
        assert result["failed"] == 0
        assert list(result)[-1] == "checks"
        return
    with faults.plant(fault):
        result, lines = rehearse(cell)
    assert not result["correct"], lines
    assert result["failed"] >= 1


def test_state_unchanged_reads_one(two_threads):
    with faults.plant("unchanged"):
        result, _ = rehearse("arch1.train")
    assert result["checks"]["change3"]["value"] == 1.0

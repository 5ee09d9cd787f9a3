"""A whole run of each cell on the CPU at a small size, past the look for a
card: the output check comes out true on the program as it is, and false
with each fault that the cell can have planted underneath (a step that
returns its state unchanged; half the batch left out; an answer altered
where it is produced), at the cell's own limits."""

import time

import pytest

from gpubench.harness import cell, faults, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CASES = [(c, None) for c in CELLS] + [
    (c, f) for c in CELLS
    for f in faults.FAULTS[spec.driver(spec.workload(c)["driver"]).Driver.mode]]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_check_sees_the_fault(name, fault, small):
    mode = spec.driver(spec.workload(name)["driver"]).Driver.mode
    seconds = 5.0 if mode == "serve" else 0.5  # a served window holds requests sent in it
    if fault is None:
        outcome = cell.run_cell(name, 2**32 + 9, seconds, False, "cpu", time.time_ns(),
                                small(name))
    else:
        with faults.planted(mode, fault):
            outcome = cell.run_cell(name, 2**32 + 9, seconds, False, "cpu", time.time_ns(),
                                    small(name))
    try:
        assert outcome.driver.attempted > 0
        assert outcome.correct is (fault is None), outcome.checks()
    finally:
        outcome.close()

"""The control comes out as not correct: the reference, put in the program's
place and computed in the precision below the configuration's (TF32 for the
float32 serving cells, float8 for the bfloat16 train cell), fails at least
one number of each cell at its own limits, on three seeds. On the card only
(TF32 and the card's float8 rounding exist there). A serving cell runs at the
CPU tests' size (``conftest.SMALL``); a train cell at its own, with just the
pairs that its checked steps read: bfloat16's rounding of the first gradient
at the CPU tests' size lies above the limits set at the cell's size.
``control.py`` reads the same at the cells' own size over many seeds."""

import time

import pytest

from gpubench.harness import cell, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _size(name, small):
    if spec.driver(spec.workload(name)["driver"]).Driver.mode != "train":
        return small(name)
    run = cell.Run(name, 0, 0.0, False, "cpu")
    pairs = int(run.cfg.training.batch_size) * int(run.params["checked_steps"])
    return {"config": {"dataset_pairs": pairs}}


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, small, card):
    limits = spec.workload(name)["limits"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        outcome = cell.run_cell(name, seed, 2.0, False, "cuda", time.time_ns(),
                                _size(name, small))
        try:
            assert outcome.correct, outcome.checks()
            control = cell.control_numbers(outcome)
        finally:
            outcome.close()
        assert any(control[k] > limit for k, limit in limits.items()), control

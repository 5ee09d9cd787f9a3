"""The benchmark's CPU tests: ``python -m pytest gpubench/tests -q`` from the
root of the checkout. Tests marked ``chip`` need a CUDA card; each decides
that inside itself and skips here with the reason."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Each cell at a size a CPU test run holds: the flagship at 64x96 with its
# DINOv2 branch at 28x42, frames of 60x80, a few clients, a pool of 16
# training pairs, at batch 4.
_PARAMS = {"frames": 8, "warmup_s": 0.3, "clients": 4, "sample_per_client": 2, "trace_s": 0.3,
           "data_processes": 1, "warmup_steps": 3}
SMALL = {
    "flagship": {"sets": ["framework.input_size=[64,96]", "framework.native_size=[60,80]",
                         "training.batch_size=4"],
                 "model_kwargs": {"dinov2_image_size": (28, 42)},
                 "reference_kwargs": {"dinov2_image_size": [28, 42]},
                 "params": _PARAMS, "config": {"dataset_pairs": 16}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def small():
    """The CPU overrides of a cell (``harness.cell.Run``), by its name."""
    return lambda cell: SMALL[cell.split(".", 1)[0]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

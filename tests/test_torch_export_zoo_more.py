"""The serving archive of the rest of the model factory's models on the CPU:
MiDaS-small, MidasNet (encoder (1, 1, 1, 1)), DPT_Large (its ViT narrowed to
64 wide at 24 blocks, in both packages) and DPT_Hybrid, built, exported and
checked as in tests/test_torch_export_zoo.py (checks (a)-(d) there)."""

import pytest
import torch

from tests import torch_export_checks as X
from tests.test_torch_export_zoo import WANT_OPS
from tests.test_torch_zoo_models import SIZE, _atol, built, narrow_vitl  # noqa: F401

torch.set_num_threads(2)

NAMES = ["dpt_hybrid", "dpt_large", "midas_small", "midas"]


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """name -> X.Archive, exported on first use."""
    root, cache = tmp_path_factory.mktemp("export_zoo_more"), {}

    def get(name):
        if name not in cache:
            cache[name] = X.Archive(built(name)[3], SIZE, root / f"{name}.mdex")
        return cache[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_exported_matches_live_step(archives, name):
    X.check_live(archives(name))


@pytest.mark.parametrize("name", NAMES)
def test_exported_matches_jax(archives, name):
    jm, params, stats, *_ = built(name)
    X.check_jax(archives(name), jm, params, stats, 1e-4, lambda w: _atol(name, w))


@pytest.mark.parametrize("name", NAMES)
def test_graphs_hold_the_kernel_ops(archives, name):
    X.check_graphs(archives(name), WANT_OPS[name], 0)


@pytest.mark.parametrize("name", NAMES)
def test_weights_round_trip(archives, name):
    X.check_weights(archives(name), {})

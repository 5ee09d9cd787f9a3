"""The system under test, ``mde_tpu_torch``, as the benchmark builds it.

The program's configuration is its default config with the configuration
file's ``--set``s, applied as the command line applies them. Its model comes
from the program's factory, built on the meta device and then given the
benchmark's seeded weights on the run's device (``weights.seeded_state``),
so that no weight is drawn on the host or leaf by leaf.

Everything of the program is imported inside these functions: a test imports
this module where the program's imports are refused.
"""

from __future__ import annotations

import torch

from . import spec
from .weights import seeded_state


def config(config_file: dict, extra_sets=()):
    """The program's config with the configuration's ``--set``s (and
    ``extra_sets`` after them)."""
    from mde_tpu_torch.core.config import defaults
    from mde_tpu_torch.tools.common import apply_sets

    return apply_sets(defaults(), [*config_file["sets"], *extra_sets])


def reference_model(config_file: dict, device, overrides=None):
    """The configuration's plain reference, on ``device`` (uninitialised)."""
    kwargs = {**config_file.get("reference_kwargs", {}), **(overrides or {})}
    with torch.device(device):
        return spec.reference(config_file["reference"]).build(**kwargs)


def weights(config_file: dict, mode: str, seed: int, device, overrides=None) -> dict:
    """The run's seeded state_dict for ``mode`` ("serve" or "train")."""
    bias = config_file["depth_bias"]
    return seeded_state(reference_model(config_file, "meta", overrides), seed, device,
                        (bias["key"], bias[mode]))


def model(cfg, state: dict, device, overrides=None):
    """The program's model for ``cfg.model``, from its factory, holding
    ``state`` on ``device``. ``overrides`` are keyword arguments of the
    model's class (the CPU tests' small DINOv2 geometry)."""
    from mde_tpu_torch.models import factory

    cls, kwargs = factory._model_class(cfg.model)
    with torch.device("meta"):
        module = cls(**{**kwargs, **(overrides or {})})
    module = module.to_empty(device=device)
    module.load_state_dict(state, strict=True)
    return module

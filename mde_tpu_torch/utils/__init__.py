"""Small helpers shared across the port (port of mde_tpu/utils/__init__.py)."""

from __future__ import annotations

import os

import torch

from ..train.checkpoint import remove_module_prefix

__all__ = ["count_params", "ensure_dir", "remove_module_prefix"]


def ensure_dir(directory: str) -> None:
    """mkdir -p (src/util.py:288-290)."""
    os.makedirs(directory, exist_ok=True)


def count_params(params) -> int:
    """The number of values in a module's parameters, or in a state_dict's
    floating-point tensors (its integer counters, such as BN's
    ``num_batches_tracked``, are not parameters)."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(v.numel() for v in params.values() if torch.is_floating_point(v))

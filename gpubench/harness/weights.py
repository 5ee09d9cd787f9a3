"""Weights from the run's seed, made by the benchmark and handed to both sides.

The names and shapes come from the configuration's plain reference, built on
the meta device; its ``state_dict()`` grammar is the program's. Every value
comes from one draw of uniform numbers on the run's device, from a
``torch.Generator`` there, in float32 (the type both sides keep their
weights in), then scaled leaf by leaf on the device:

- convolutions, transposed convolutions and linears: torch's default
  kaiming-uniform bounds, weight +-sqrt(1/fan_in), bias +-1/sqrt(fan_in);
- batch and layer norms: scale in [0.8, 1.2], shift in [-0.1, 0.1]; batch
  norms' running mean in [-0.1, 0.1] and running variance in [0.75, 1.25],
  so that a path that ignores them shows;
- LayerScale gammas in [0.2, 0.8], so that the attention shows;
- a ViT's class token and position embedding in [-0.04, 0.04]; its mask
  token (masked-image training only) 0;
- the configuration's final depth bias raised by the mode's ``depth_bias``
  (a random depth tail sits at its ReLU: most of the map would compare 0
  to 0).

A leaf that none of these rules covers raises: the recipe names every leaf.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn as nn

# (low, high) of each rule's uniform draw; None: a fixed value
_NORM_SCALE, _NORM_SHIFT = (0.8, 1.2), (-0.1, 0.1)
_RUNNING_MEAN, _RUNNING_VAR = (-0.1, 0.1), (0.75, 1.25)
_LAYERSCALE, _TOKENS = (0.2, 0.8), (-0.04, 0.04)


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``seed``."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), zlib.crc32(tag.encode())])
    a, b = state.generate_state(2)
    return (int(a) << 32 | int(b)) & (2**63 - 1)


def _ranges(module: nn.Module) -> dict:
    """Every leaf of ``module``'s state_dict -> (low, high), or a float for a
    fixed value."""
    out = {}
    for prefix, m in module.named_modules():
        dot = f"{prefix}." if prefix else ""
        leaves = dict(m.named_parameters(recurse=False))
        leaves.update(m.named_buffers(recurse=False))
        for leaf in leaves:
            key = dot + leaf
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
                bound = (1.0 / fan_in) ** 0.5
                out[key] = (-bound, bound)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                out[key] = {"weight": _NORM_SCALE, "bias": _NORM_SHIFT,
                            "running_mean": _RUNNING_MEAN, "running_var": _RUNNING_VAR,
                            "num_batches_tracked": 0.0}[leaf]
            elif leaf == "gamma":
                out[key] = _LAYERSCALE
            elif leaf in ("cls_token", "pos_embed"):
                out[key] = _TOKENS
            elif leaf == "mask_token":
                out[key] = 0.0
            else:
                raise ValueError(f"no weight rule for {key} ({type(m).__name__})")
    return out


def seeded_state(reference: nn.Module, seed: int, device, depth_bias: tuple = None) -> dict:
    """The state_dict of ``reference`` (built on the meta device) with values
    from ``seed`` on ``device``. ``depth_bias`` (key, amount) raises that
    bias."""
    ranges = _ranges(reference)
    shapes = {k: v.shape for k, v in reference.state_dict().items()}
    if set(ranges) != set(shapes):
        raise ValueError(f"leaves without a rule: {sorted(set(shapes) - set(ranges))}")
    drawn = [k for k in shapes if isinstance(ranges[k], tuple)]
    total = sum(shapes[k].numel() for k in drawn)
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    state, at = {}, 0
    for key, shape in shapes.items():
        rule = ranges[key]
        if isinstance(rule, tuple):
            lo, hi = rule
            n = shape.numel()
            state[key] = (flat[at:at + n] * (hi - lo) + lo).view(shape)
            at += n
        elif key.endswith("num_batches_tracked"):
            state[key] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            state[key] = torch.full(shape, rule, dtype=torch.float32, device=device)
    if depth_bias is not None:
        key, amount = depth_bias
        state[key] = state[key] + amount
    return state

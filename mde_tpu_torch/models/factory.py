"""Model factory (port of mde_tpu/models/factory.py).

Two branches are ported: ``model_type: MiDaS_small`` with a ``dinov2_type``
builds MidasNetSemantics (the flagship), and ``DepthAnythingV2_{vits,vitb,vitl}``
builds DepthAnythingV2 of that size. Every other branch raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import torch

from ..nn.blocks import init_weights_
from .depth_anything import DepthAnythingV2
from .midas_semantics import MidasNetSemantics


def build_model(model_cfg, device, generator: torch.Generator):
    """Construct the module for a config ``model`` section on ``device``, with
    weights drawn from ``generator`` (a CPU ``torch.Generator``)."""
    model_type = model_cfg.model_type
    network_cfg = model_cfg.get("network", model_cfg)
    for flag in ("use_lb", "use_dgr"):
        if network_cfg.get(flag, False):
            raise NotImplementedError(
                f"{flag} is not ported to mde_tpu_torch yet "
                "(ROADMAP.md, Queue 1: the rest of the model zoo)")
    if model_type.startswith("DepthAnythingV2"):
        size = model_type.split("_")[-1] if "_" in model_type else "vits"
        cls, kwargs = DepthAnythingV2, {"size": size}
    elif model_type == "MiDaS_small" and model_cfg.get("dinov2_type") is not None:
        cls, kwargs = MidasNetSemantics, {"features": 64, "backbone": "efficientnet_lite3",
                                          "dinov2_type": model_cfg.dinov2_type}
    else:
        raise NotImplementedError(
            f"model_type {model_type!r} with dinov2_type {model_cfg.get('dinov2_type')!r} "
            "is not ported to mde_tpu_torch yet (ROADMAP.md, Queue 1: the rest of the "
            "model zoo)")
    with torch.device("meta"):
        model = cls(**kwargs)
    model = model.to_empty(device="cpu")
    init_weights_(model, generator)
    return model.to(device)

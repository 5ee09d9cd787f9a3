"""Model factory (port of mde_tpu/models/factory.py).

  model_type               dinov2_type   ->  model
  "MiDaS_small"            set           ->  MidasNetSemantics (the flagship)
  "MiDaS_small"            null          ->  MidasNetSmall
  "MiDaS"                  -             ->  MidasNet (ResNeXt101 encoder)
  "DPT_Large"              -             ->  DPTDepthModel(vitl16_384)
  "DPT_Hybrid"             -             ->  DPTDepthModel(vitb_rn50_384)
  "U_Net"                  -             ->  SimpleUNet
  "DepthAnythingV2_{size}" -             ->  DepthAnythingV2 of that size

``model.network.use_lb`` / ``use_dgr`` (or the same keys on ``model``) reach
both MiDaS-small models, as in mde_tpu; the flagship takes ``use_dgr`` and
does not apply it.
"""

from __future__ import annotations

import torch

from ..nn.blocks import init_weights_
from .depth_anything import DepthAnythingV2
from .dpt import DPTDepthModel
from .midas_net import MidasNet
from .midas_semantics import MidasNetSemantics
from .midas_small import MidasNetSmall
from .simple_unet import SimpleUNet


def _model_class(model_cfg):
    model_type = model_cfg.model_type
    network_cfg = model_cfg.get("network", model_cfg)
    flags = {"use_lb": bool(network_cfg.get("use_lb", False)),
             "use_dgr": bool(network_cfg.get("use_dgr", False))}
    if model_type == "MiDaS_small":
        if model_cfg.get("dinov2_type") is not None:
            return MidasNetSemantics, {"features": 64, "backbone": "efficientnet_lite3",
                                       "dinov2_type": model_cfg.dinov2_type, **flags}
        return MidasNetSmall, {"features": 64, "backbone": "efficientnet_lite3", **flags}
    if model_type == "MiDaS":
        return MidasNet, {"features": 256}
    if model_type == "DPT_Hybrid":
        return DPTDepthModel, {"backbone": "vitb_rn50_384"}
    if model_type == "DPT_Large":
        return DPTDepthModel, {"backbone": "vitl16_384"}
    if model_type == "U_Net":
        return SimpleUNet, {}
    if model_type.startswith("DepthAnythingV2"):
        return DepthAnythingV2, {"size": model_type.split("_")[-1] if "_" in model_type
                                 else "vits"}
    raise ValueError(f"Unknown model_type: {model_type!r}")


def build_model(model_cfg, device, generator: torch.Generator):
    """Construct the module for a config ``model`` section on ``device``, with
    weights drawn from ``generator`` (a CPU ``torch.Generator``)."""
    cls, kwargs = _model_class(model_cfg)
    with torch.device("meta"):
        model = cls(**kwargs)
    model = model.to_empty(device="cpu")
    init_weights_(model, generator)
    return model.to(device)

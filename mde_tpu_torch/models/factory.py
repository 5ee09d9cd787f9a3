"""Model factory (port of mde_tpu/models/factory.py).

  model_type               dinov2_type   ->  model
  "MiDaS_small"            set           ->  MidasNetSemantics (the flagship)
  "MiDaS_small"            null          ->  MidasNetSmall
  "MiDaS"                  -             ->  MidasNet (ResNeXt101 encoder)
  "DPT_Large"              -             ->  DPTDepthModel(vitl16_384)
  "DPT_Hybrid"             -             ->  DPTDepthModel(vitb_rn50_384)
  "U_Net"                  -             ->  SimpleUNet
  "DepthAnythingV2_{size}" -             ->  DepthAnythingV2 of that size
  a DPT row of ``model_loader.DEFAULT_MODELS`` (``dpt_beit_base_384``,
  ``dpt_swin2_tiny_256`` ...) ->  DPTDepthModel on that trunk, built for the
                                 row's input size (the CLIs' config takes it
                                 as ``framework.input_size``)

The loader rows are the port's: mde_tpu's factory has none, and its tools
reach those models only through ``model_loader``. Here the training CLI,
the server and the offline tools build them from ``model.model_type``.

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
    from .model_loader import DEFAULT_MODELS, row_class

    if isinstance(DEFAULT_MODELS.get(model_type, (None,))[0], dict):
        return row_class(model_type)
    raise ValueError(f"Unknown model_type: {model_type!r}")


def build_module(cls, kwargs: dict, device, generator: torch.Generator):
    """``cls(**kwargs)`` on ``device``, with weights drawn from ``generator``
    (a CPU ``torch.Generator``): built on the meta device, then given values
    on the CPU by ``init_weights_``."""
    with torch.device("meta"):
        model = cls(**kwargs)
    model = model.to_empty(device="cpu")
    init_weights_(model, generator)
    return model.to(device)


def build_model(model_cfg, device, generator: torch.Generator):
    """Construct the module for a config ``model`` section on ``device``, with
    weights drawn from ``generator`` (a CPU ``torch.Generator``)."""
    cls, kwargs = _model_class(model_cfg)
    return build_module(cls, kwargs, device, generator)

"""Encoder registry (port of mde_tpu/nn/registry.py): the reference's
``_make_encoder`` names (src/network/blocks.py:32-130) with their per-level
channel tables.

The convolutional backbones (the EfficientNet-Lite family and
``resnext101_wsl``) build through ``make_encoder``'s four-feature-map
interface. The token and hierarchical backbones (the "vit"/"dpt" markers) are
consumed through models/dpt.py's reassembly, so ``make_encoder`` raises for
them, as mde_tpu's does.
"""

from __future__ import annotations

from typing import Callable, Union

from .efficientnet import LITE_MULTIPLIERS, EfficientNetLite, lite_stage_channels
from .resnext import ResNetBackbone

# name -> (channel table for the scratch convs, builder | "vit" | "dpt")
ENCODER_REGISTRY: dict[str, tuple[list[int], Union[Callable, str]]] = {
    "beitl16_512": ([256, 512, 1024, 1024], "dpt"),
    "beitl16_384": ([256, 512, 1024, 1024], "dpt"),
    "beitb16_384": ([96, 192, 384, 768], "dpt"),
    "swin2l24_384": ([192, 384, 768, 1536], "dpt"),
    "swin2b24_384": ([128, 256, 512, 1024], "dpt"),
    "swin2t16_256": ([96, 192, 384, 768], "dpt"),
    "swinl12_384": ([192, 384, 768, 1536], "dpt"),
    "next_vit_large_6m": ([96, 256, 512, 1024], "dpt"),
    "levit_384": ([384, 512, 768], "dpt"),
    "vitl16_384": ([256, 512, 1024, 1024], "vit"),
    "vitb_rn50_384": ([256, 512, 768, 768], "dpt"),
    "vitb16_384": ([96, 192, 384, 768], "vit"),
    "resnext101_wsl": ([256, 512, 1024, 2048], ResNetBackbone),
    **{v: (lite_stage_channels(v), (lambda v: lambda: EfficientNetLite(v))(v))
       for v in LITE_MULTIPLIERS},
}


def _entry(backbone: str):
    if backbone not in ENCODER_REGISTRY:
        raise ValueError(f"Backbone {backbone!r} not in registry")
    return ENCODER_REGISTRY[backbone]


def encoder_channels(backbone: str) -> list[int]:
    return list(_entry(backbone)[0])


def make_encoder(backbone: str):
    """Build the stage-sliced feature backbone for ``backbone``."""
    builder = _entry(backbone)[1]
    if builder in ("vit", "dpt"):
        raise NotImplementedError(
            f"Backbone {backbone!r} is a token/hierarchical backbone consumed through "
            "models.dpt.DPTDepthModel, not the 4-feature-map interface")
    return builder()

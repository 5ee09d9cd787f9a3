"""MiDaS v3.1's model table and its loader (port of mde_tpu/models/model_loader.py).

``DEFAULT_MODELS`` names the reference's 14 checkpoints (a MiDaS-repo vestige
of src/network/model_loader.py) with each one's constructor, input size and
host preprocessing pipeline (data/midas_transforms.py). ``load_model`` builds
the model with weights from a seed; restoring a checkpoint that exists is the
caller's job (train/checkpoint.py), as in mde_tpu, and a path that does not
exist prints a note. The openvino entry is an inference engine's and raises.
``row_class`` resolves a row to its constructor, here and for the model
factory (models/factory.py), whose ``model.model_type`` takes the DPT rows
(mde_tpu's factory has none).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .dpt import DPTDepthModel
from .factory import build_module
from .midas_net import MidasNet
from .midas_small import MidasNetSmall

# name -> (constructor kwargs or None, input (h, w), transform pipeline name)
DEFAULT_MODELS = {
    "dpt_beit_large_512": (dict(backbone="beitl16_512"), (512, 512), "beit512"),
    "dpt_beit_large_384": (dict(backbone="beitl16_384"), (384, 384), "dpt"),
    "dpt_beit_base_384": (dict(backbone="beitb16_384"), (384, 384), "dpt"),
    "dpt_swin2_large_384": (dict(backbone="swin2l24_384"), (384, 384), "swin384"),
    "dpt_swin2_base_384": (dict(backbone="swin2b24_384"), (384, 384), "swin384"),
    "dpt_swin2_tiny_256": (dict(backbone="swin2t16_256"), (256, 256), "swin256"),
    "dpt_swin_large_384": (dict(backbone="swinl12_384"), (384, 384), "swin384"),
    "dpt_next_vit_large_384": (dict(backbone="next_vit_large_6m"), (384, 384), "dpt"),
    "dpt_levit_224": (dict(backbone="levit_384", head_features_1=64, head_features_2=8),
                      (224, 224), "levit"),
    "dpt_large_384": (dict(backbone="vitl16_384"), (384, 384), "dpt"),
    "dpt_hybrid_384": (dict(backbone="vitb_rn50_384"), (384, 384), "dpt"),
    "midas_v21_384": ("midas", (384, 384), "default"),
    "midas_v21_small_256": ("midas_small", (256, 256), "small"),
    "openvino_midas_v21_small_256": (None, (256, 256), "small"),
}


def row_class(model_type: str):
    """(class, constructor kwargs) of a ``DEFAULT_MODELS`` row that has a
    constructor: a DPT built for the row's input size, or a MiDaS CNN."""
    spec, size, _ = DEFAULT_MODELS[model_type]
    if spec == "midas":
        return MidasNet, {}
    if spec == "midas_small":
        return MidasNetSmall, {}
    return DPTDepthModel, {**spec, "input_size": size}


def load_model(model_type: str = "dpt_beit_large_512", model_path: Optional[str] = None,
               device="cuda", generator: Optional[torch.Generator] = None):
    """(model, input (h, w), transform) for a ``DEFAULT_MODELS`` entry.

    The model is on ``device`` (the card unless the caller asks for the CPU;
    "cuda" with no card raises), with weights drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None). LeViT's bias tables are built for
    the entry's input size. ``transform`` is the entry's host pipeline.
    """
    if model_type not in DEFAULT_MODELS:
        raise ValueError(f"Unknown model_type {model_type!r}; have {sorted(DEFAULT_MODELS)}")
    spec, size, transform_name = DEFAULT_MODELS[model_type]
    if spec is None:
        raise NotImplementedError(f"{model_type!r} is registered but unsupported "
                                  "(openvino is an inference-engine-specific backend)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_model({model_type!r}, device={str(device)!r}): no CUDA "
                           "device is visible")
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    model = build_module(*row_class(model_type), device, generator)

    from ..data.midas_transforms import transforms

    if model_path and not os.path.exists(model_path):
        print(f"Note: checkpoint {model_path} not found; model is randomly initialized.")
    return model, size, transforms()[transform_name]

"""JAX model parameters -> the port's state_dict.

``state_dict_from_flax`` is the inverse of the JAX package's import maps, with
the layouts of its ``convert_tensor`` (mde_tpu/train/torch_import.py:49-67):
``map_midas_small_key`` (with ``map_localbins_key`` and ``map_dgr_key``),
``map_midas_semantics_key``, ``map_simple_unet_key``, ``map_midas_net_key``,
``map_dpt_key`` (ViT and hybrid) and ``map_depth_anything_key``. It takes the
flax parameter and batch-statistics trees as nested dicts of numpy arrays
(flax names) and needs no flax or jax itself:

  conv            HWIO          -> OIHW (depthwise and grouped too)
  conv-transpose  (H, W, I, O)  -> (I, O, H, W)
  Dense           (in, out)     -> (out, in)
  BatchNorm       scale/bias/mean/var -> weight/bias/running_mean/running_var
  LayerNorm, GroupNorm  scale/bias    -> weight/bias
  ViTs            pos_embed, cls_token, LayerScale gammas as they are

The reference grammar's dead keys (each model's ``DEAD_KEY_PREFIXES``: modules
no forward reads, and the constants DGR and LocalBins rebuild) and BN's
``num_batches_tracked`` have no flax counterpart and are not produced.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# encoder stage -> (layer, slot) of the gen-efficientnet Sequential slicing
_EFFNET_SLOT = {0: (1, 3), 1: (1, 4), 2: (2, 0), 3: (3, 0), 4: (3, 1), 5: (4, 0), 6: (4, 1)}
# stage-1 (expand 1) blocks: flax submodule -> torch DepthwiseSeparableConv name
_DS_RENAME = {"conv_dw": "conv_dw", "bn2": "bn1", "conv_pwl": "conv_pw", "bn3": "bn2"}
_RB_RENAME = {"shortcut_conv": "shortcut.0", "shortcut_bn": "shortcut.1"}


def _effnet_block(m):
    stage, rep, sub = int(m[1]), m[2], m[3]
    layer, slot = _EFFNET_SLOT[stage]
    if stage == 0:
        sub = _DS_RENAME[sub]
    return f"pretrained.layer{layer}.{slot}.{rep}.{sub}"


def _midas_small_rules(flax: str):
    """models/midas_small.py::MidasNetSmall under the flax module ``flax``
    ("" at the top); its port keys are top-level either way."""
    pre = f"{flax}/" if flax else ""
    return [
        (rf"{pre}pretrained/conv_stem", lambda m: "pretrained.layer1.0"),
        (rf"{pre}pretrained/bn1", lambda m: "pretrained.layer1.1"),
        (rf"{pre}pretrained/blocks_(\d)_(\d+)/(\w+)", _effnet_block),
        (rf"{pre}scratch/(layer\d_rn)", lambda m: f"scratch.{m[1]}"),
        (rf"{pre}(refinenet\d/.+)", lambda m: f"scratch.{m[1]}"),
        (rf"{pre}output_conv(\d)", lambda m: f"scratch.output_conv.{m[1]}"),
        (rf"{pre}dgr(\d)/recalib(\d)", lambda m: f"dgr{m[1]}.recalib.{m[2]}"),
        (rf"{pre}dgr(\d)/spatial", lambda m: f"dgr{m[1]}.spatial"),
    ]


# models/localbins.py::LocalBinsBlock at the top level: MLP convs at _net.0/.2
_LOCALBINS_RULES = [
    (r"local_bins/conv2", lambda m: "local_bins.conv2"),
    (r"local_bins/(seed_bin_regressor|seed_projector)/net(\d)",
     lambda m: f"local_bins.{m[1]}._net.{m[2]}"),
    (r"local_bins/(projectors|attractors)_(\d)/net(\d)",
     lambda m: f"local_bins.{m[1]}.{m[2]}._net.{m[3]}"),
    (r"local_bins/conditional_log_binomial/mlp(\d)",
     lambda m: f"local_bins.conditional_log_binomial.mlp.{m[1]}"),
]


def _seq(name: str, offset: int):
    """Conv-BN-ReLU Sequentials: module i sits at index 3 i + offset."""
    return lambda m: f"cross_attention.{name}.{3 * int(m[1]) + offset}"


def _vit_rules(flax: str, port: str):
    """The DINOv2 trunk: the module itself holds cls_token and pos_embed."""
    return [
        (flax, lambda m: port),
        (rf"{flax}/patch_embed", lambda m: f"{port}.patch_embed.proj"),
        (rf"{flax}/blocks_(\d+)/(.+)", lambda m: f"{port}.blocks.{m[1]}.{m[2]}"),
        (rf"{flax}/norm", lambda m: f"{port}.norm"),
    ]


def _dinov2_head_rules(flax: str, port: str):
    """models/midas_semantics.py::Dinov2Head; the flagship's ends at output_conv2.0."""
    return [
        (rf"{flax}/projects_(\d)", lambda m: f"{port}.projects.{m[1]}"),
        (rf"{flax}/resize_(\d)", lambda m: f"{port}.resize_layers.{m[1]}"),
        (rf"{flax}/scratch/(layer\d_rn)", lambda m: f"{port}.scratch.{m[1]}"),
        (rf"{flax}/(refinenet\d/.+)", lambda m: f"{port}.scratch.{m[1]}"),
        (rf"{flax}/output_conv1", lambda m: f"{port}.scratch.output_conv1"),
        (rf"{flax}/output_conv2_0", lambda m: f"{port}.scratch.output_conv2.0"),
    ]


# Per model: (flax module path joined with "/", torch module key); first match wins.
_FLAGSHIP_RULES = [
    *_midas_small_rules("midas"),
    *_LOCALBINS_RULES,
    *_vit_rules("dinov2", "dinov2"),
    *_dinov2_head_rules("dinov2_head", "dinov2_head"),
    (r"cross_attention/spatial_reduction/conv(\d)", _seq("spatial_reduction", 0)),
    (r"cross_attention/spatial_reduction/bn(\d)", _seq("spatial_reduction", 1)),
    (r"cross_attention/spatial_upsample_conv(\d)", _seq("spatial_upsample", 0)),
    (r"cross_attention/spatial_upsample_bn(\d)", _seq("spatial_upsample", 1)),
    (r"cross_attention/(\w+)", lambda m: f"cross_attention.{m[1]}"),
    (r"(fusion_blocks|fusion_head|depth_head)_0/(\w+)",
     lambda m: f"{m[1]}.0.{_RB_RENAME.get(m[2], m[2])}"),
    (r"(fusion_head|depth_head)_1", lambda m: f"{m[1]}.1"),
    (r"fusion_head_bn", lambda m: "fusion_head.2"),
]

# DA-V2's release names: the JAX top-level ``final`` 1x1 is output_conv2.2.
_DA2_RULES = [
    *_vit_rules("pretrained", "pretrained"),
    *_dinov2_head_rules("depth_head", "depth_head"),
    (r"final", lambda m: "depth_head.scratch.output_conv2.2"),
]

_UNET_RULES = [
    (r"(enc1|enc2|dec1|dec2)/(conv1|conv2|bn1|bn2)", lambda m: f"{m[1]}.{m[2]}"),
    (r"final", lambda m: "final"),
]

_BOTTLENECK_RENAME = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}

# The stem and stage 1 sit in pretrained.layer1 (conv 0, BN 1, bottlenecks 4.N)
_MIDAS_NET_RULES = [
    (r"pretrained/conv1", lambda m: "pretrained.layer1.0"),
    (r"pretrained/bn1", lambda m: "pretrained.layer1.1"),
    (r"pretrained/layer(\d)_(\d+)/(\w+)",
     lambda m: f"pretrained.layer{m[1]}.{'4.' if m[1] == '1' else ''}{m[2]}."
               f"{_BOTTLENECK_RENAME.get(m[3], m[3])}"),
    (r"scratch/(layer\d_rn)", lambda m: f"scratch.{m[1]}"),
    (r"(refinenet\d/.+)", lambda m: f"scratch.{m[1]}"),
    (r"output_conv(\d)", lambda m: f"scratch.output_conv.{m[1]}"),
]

_RESNETV2 = "pretrained.model.patch_embed.backbone"
_PREACT_RENAME = {"gn1": "norm1", "gn2": "norm2", "gn3": "norm3", "downsample": "downsample.conv"}

# DPT: the ViT rows' trunk is the flax ``pretrained``; the hybrid's blocks,
# tokens and 1x1 patch embedding sit at the top and its ResNetV2 is
# ``pretrained_resnet``. Level i's readout, 1x1 and resize are
# act_postprocess{i+1}.0.project.0, .3 and .4.
_DPT_RULES = [
    *_vit_rules("pretrained", "pretrained.model"),
    ("", lambda m: "pretrained.model"),
    (r"patch_embed", lambda m: "pretrained.model.patch_embed.proj"),
    (r"blocks_(\d+)/(.+)", lambda m: f"pretrained.model.blocks.{m[1]}.{m[2]}"),
    (r"pretrained_resnet/conv_stem", lambda m: f"{_RESNETV2}.stem.conv"),
    (r"pretrained_resnet/gn_stem", lambda m: f"{_RESNETV2}.stem.norm"),
    (r"pretrained_resnet/stage(\d)_block(\d+)/(\w+)",
     lambda m: f"{_RESNETV2}.stages.{m[1]}.blocks.{m[2]}.{_PREACT_RENAME.get(m[3], m[3])}"),
    (r"readout_(\d)/project", lambda m: f"pretrained.act_postprocess{int(m[1]) + 1}.0.project.0"),
    (r"act_postprocess_(\d)", lambda m: f"pretrained.act_postprocess{int(m[1]) + 1}.3"),
    (r"resize_(\d)", lambda m: f"pretrained.act_postprocess{int(m[1]) + 1}.4"),
    (r"scratch/(layer\d_rn)", lambda m: f"scratch.{m[1]}"),
    (r"(refinenet\d/.+)", lambda m: f"scratch.{m[1]}"),
    (r"head_conv(\d)", lambda m: f"scratch.output_conv.{m[1]}"),
]

MODEL_RULES = {
    "MidasNetSemantics": _FLAGSHIP_RULES,
    "MidasNetSmall": [*_midas_small_rules(""), *_LOCALBINS_RULES],
    "SimpleUNet": _UNET_RULES,
    "MidasNet": _MIDAS_NET_RULES,
    "DPTDepthModel": _DPT_RULES,
    "DepthAnythingV2": _DA2_RULES,
}

_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _module_key(rules, path: str) -> str:
    for pattern, key in rules:
        m = re.fullmatch(pattern, path)
        if m:
            return key(m).replace("/", ".")
    raise KeyError(f"no port name for flax module {path!r}")


def _convert(module: str, wrapper, leaf: str, value: np.ndarray):
    """-> (torch leaf name, array in torch layout) for one flax leaf."""
    if wrapper in ("BatchNorm_0", "LayerNorm_0") or leaf == "scale":  # GroupNorm: no wrapper
        return _NORM_LEAF[leaf], value
    if leaf == "bias" or leaf in ("cls_token", "pos_embed", "gamma"):
        return leaf, value
    if leaf != "kernel":
        raise KeyError(f"unexpected flax leaf {module}/{leaf}")
    if value.ndim == 2:
        return "weight", np.transpose(value, (1, 0))  # Dense (in, out) -> (out, in)
    if re.search(r"resize_layers\.[01]$|spatial_upsample\.\d$|act_postprocess[12]\.4$", module):
        return "weight", np.transpose(value, (2, 3, 0, 1))  # (H, W, I, O) -> (I, O, H, W)
    return "weight", np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW, grouped and depthwise too


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(params, batch_stats, model: str = "MidasNetSemantics") -> dict:
    """Flax ``params`` and ``batch_stats`` of ``model`` (a ``MODEL_RULES`` key:
    the class name of the port's module) -> the port's state_dict (float32
    CPU tensors, keys in the reference grammar)."""
    rules = MODEL_RULES[model]
    out = {}
    for tree in (params, batch_stats or {}):
        for path, value in _flatten(tree):
            mod, leaf = path[:-1], path[-1]
            wrapper = None
            if mod and mod[-1] in ("Conv_0", "BatchNorm_0", "LayerNorm_0"):
                wrapper, mod = mod[-1], mod[:-1]
            module = _module_key(rules, "/".join(mod))
            name, arr = _convert(module, wrapper, leaf, np.asarray(value, np.float32))
            out[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return out

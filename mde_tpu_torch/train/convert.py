"""JAX model parameters -> the port's state_dict.

``state_dict_from_flax`` is the inverse of the JAX package's import maps, with
the layouts of its ``convert_tensor`` (mde_tpu/train/torch_import.py:49-67):
``map_midas_semantics_key`` (:437-500) for the flagship, and
``map_depth_anything_key`` (:702-718) for Depth-Anything-V2. It takes the flax
parameter and batch-statistics trees as nested dicts of numpy arrays (flax
names) and needs no flax or jax itself:

  conv            HWIO          -> OIHW
  depthwise conv  (H, W, 1, O)  -> (O, 1, H, W)
  conv-transpose  (H, W, I, O)  -> (I, O, H, W)
  Dense           (in, out)     -> (out, in)
  BatchNorm       scale/bias/mean/var -> weight/bias/running_mean/running_var
  LayerNorm       scale/bias    -> weight/bias
  DINOv2          pos_embed, cls_token, LayerScale gammas as they are

The reference grammar's dead keys (each model's ``DEAD_KEY_PREFIXES``) and
BN's ``num_batches_tracked`` have no flax counterpart and are not produced.
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
    (r"midas/pretrained/conv_stem", lambda m: "pretrained.layer1.0"),
    (r"midas/pretrained/bn1", lambda m: "pretrained.layer1.1"),
    (r"midas/pretrained/blocks_(\d)_(\d+)/(\w+)", _effnet_block),
    (r"midas/scratch/(layer\d_rn)", lambda m: f"scratch.{m[1]}"),
    (r"midas/(refinenet\d/.+)", lambda m: f"scratch.{m[1]}"),
    (r"midas/output_conv(\d)", lambda m: f"scratch.output_conv.{m[1]}"),
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

MODEL_RULES = {"MidasNetSemantics": _FLAGSHIP_RULES, "DepthAnythingV2": _DA2_RULES}

_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _module_key(rules, path: str) -> str:
    for pattern, key in rules:
        m = re.fullmatch(pattern, path)
        if m:
            return key(m).replace("/", ".")
    raise KeyError(f"no port name for flax module {path!r}")


def _convert(module: str, wrapper, leaf: str, value: np.ndarray):
    """-> (torch leaf name, array in torch layout) for one flax leaf."""
    if wrapper in ("BatchNorm_0", "LayerNorm_0"):
        return _NORM_LEAF[leaf], value
    if leaf == "bias" or leaf in ("cls_token", "pos_embed", "gamma"):
        return leaf, value
    if leaf != "kernel":
        raise KeyError(f"unexpected flax leaf {module}/{leaf}")
    if wrapper == "Conv_0" or module.endswith("patch_embed.proj"):
        return "weight", np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW, also depthwise
    if re.search(r"resize_layers\.[01]$|spatial_upsample\.\d$", module):
        return "weight", np.transpose(value, (2, 3, 0, 1))  # (H, W, I, O) -> (I, O, H, W)
    return "weight", np.transpose(value, (1, 0))  # Dense (in, out) -> (out, in)


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

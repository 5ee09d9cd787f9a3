"""JAX model parameters -> the port's state_dict.

``state_dict_from_flax`` is the inverse of the JAX package's import maps, with
the layouts of its ``convert_tensor`` (mde_tpu/train/torch_import.py:49-67):
``map_midas_small_key`` (with ``map_localbins_key`` and ``map_dgr_key``),
``map_midas_semantics_key``, ``map_simple_unet_key``, ``map_midas_net_key``,
the DPT maps (``map_dpt_key`` for ViT and hybrid, ``map_dpt_beit_key``,
``map_dpt_swin_key`` V1 and V2, ``map_dpt_levit_key``; Next-ViT has no map,
and the port keeps mde_tpu's names under ``pretrained.model``) and
``map_depth_anything_key``. It takes the flax parameter and batch-statistics
trees as nested dicts of numpy arrays (flax names) and needs no flax or jax
itself:

  conv            HWIO          -> OIHW (depthwise and grouped too)
  conv-transpose  (H, W, I, O)  -> (I, O, H, W)
  Dense           (in, out)     -> (out, in)
  BatchNorm       scale/bias/mean/var -> weight/bias/running_mean/running_var
  LayerNorm, GroupNorm  scale/bias    -> weight/bias
  ViTs            pos_embed, cls_token, LayerScale gammas as they are
  bias tables     BEiT's, Swin V1's, LeViT's; Swin V2's logit_scale

then the DPT trunks' fused layouts (``_fuse_dpt_trunk``): BEiT's q, k and v
into ``qkv.weight`` with ``q_bias``/``v_bias`` and its table's three class
slots into timm's order; Swin V2's qkv bias into ``q_bias``/``v_bias``; Swin's
merge reduction (and V1's 4C norm) into timm's 2x2 order; LeViT's q and kv
into timm's per-head [q|k|v] (and a subsample's kv into per-head [k|v]),
weights and BN vectors alike. LeViT's bias-table offsets are in the same
(lexicographic) order on both sides.

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

# LeViT's stage attention/MLP pairs start at flat blocks 0, 10 and 20
_LEVIT_FIRST = (0, 10, 20)
_LEVIT_LAYER = {"fc1": "0", "fc2": "2", "proj": "proj.1", "linear": "c"}


def _levit_block(m):
    """A LeViT flax module -> its place in timm's flat ``blocks``: stage s's
    pair b at 2b (+1) past _LEVIT_FIRST[s], the subsample attention and MLP
    opening stage s at 10s - 2 and 10s - 1. Stage blocks and every MLP sit in
    a Residual (``m``); a subsample's q is Sequential(Subsample, LinearNorm)."""
    stage = re.fullmatch(r"stage(\d)_(attn|mlp)(\d)", m[1])
    if stage:
        flat = _LEVIT_FIRST[int(stage[1])] + 2 * int(stage[3]) + (stage[2] == "mlp")
        head = [str(flat), "m"]
    else:
        sub = re.fullmatch(r"downsample(\d)_(attn|mlp)", m[1])
        head = [str(10 * int(sub[1]) - 2 + (sub[2] == "mlp"))] + (["m"] if sub[2] == "mlp" else [])
    rest = [_LEVIT_LAYER.get(p, p) for p in (m[4] or "").split("/") if p]
    if rest[:1] == ["q"] and not stage:
        rest[0] = "q.1"
    return ".".join(["pretrained.model.blocks", *head, *rest])


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
    # Swin: stage i's blocks, and the merge that opens stage i (timm's
    # downsample closing stage i - 1)
    (r"pretrained/patch_norm", lambda m: "pretrained.model.patch_embed.norm"),
    (r"pretrained/merge(\d)/(\w+)",
     lambda m: f"pretrained.model.layers.{int(m[1]) - 1}.downsample.{m[2]}"),
    (r"pretrained/stage(\d)_block(\d+)/attn/cpb_fc(\d)",
     lambda m: f"pretrained.model.layers.{m[1]}.blocks.{m[2]}.attn.cpb_mlp."
               f"{2 * (int(m[3]) - 1)}"),
    (r"pretrained/stage(\d)_block(\d+)/((attn|norm1|norm2|mlp)(/.+)?)",
     lambda m: f"pretrained.model.layers.{m[1]}.blocks.{m[2]}.{m[3]}"),
    # Next-ViT: mde_tpu's names
    (r"pretrained/(stem\d|stage\d_block\d+)/(.+)", lambda m: f"pretrained.model.{m[1]}.{m[2]}"),
    # LeViT: the stem's ConvNorms at 0, 2, 4, 6; timm's flat blocks
    (r"pretrained/stem_(conv|bn)(\d)",
     lambda m: f"pretrained.model.patch_embed.{2 * int(m[2])}.{'c' if m[1] == 'conv' else 'bn'}"),
    (r"pretrained/(stage\d_(attn|mlp)\d|downsample\d_(attn|mlp))(/.+)?", _levit_block),
    (r"stem_transpose/up(\d)(_bn)?",
     lambda m: f"scratch.stem_transpose.{2 * (int(m[1]) - 1)}.{'bn' if m[2] else 'c'}"),
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
_AS_IS = ("cls_token", "pos_embed", "gamma", "relative_position_bias_table", "logit_scale",
          "attention_biases")


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
    if leaf == "bias" or leaf in _AS_IS:
        return leaf, value
    if leaf != "kernel":
        raise KeyError(f"unexpected flax leaf {module}/{leaf}")
    if value.ndim == 2:
        return "weight", np.transpose(value, (1, 0))  # Dense (in, out) -> (out, in)
    if re.search(r"resize_layers\.[01]$|spatial_upsample\.\d$|act_postprocess[12]\.4$"
                 r"|stem_transpose\.[02]\.c$", module):
        return "weight", np.transpose(value, (2, 3, 0, 1))  # (H, W, I, O) -> (I, O, H, W)
    return "weight", np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW, grouped and depthwise too


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _groups(t: torch.Tensor, n: int, order, dim: int = 0) -> torch.Tensor:
    """``t`` cut into ``n`` equal groups along ``dim``, put back in ``order``."""
    parts = t.chunk(n, dim)
    return torch.cat([parts[i] for i in order], dim)


def _per_head(*parts: torch.Tensor, heads: int) -> torch.Tensor:
    """Row blocks each holding ``heads`` heads one after another -> the heads'
    rows interleaved: head 0 of every part, then head 1, ..."""
    return torch.cat([r for h in zip(*(p.chunk(heads) for p in parts)) for r in h])


def _fuse_dpt_trunk(sd: dict) -> dict:
    """mde_tpu's separate projections -> the fused layouts of timm's BEiT,
    Swin V2 and LeViT (module docstring). ``sd`` holds the converted leaves
    under their port names; returns the port's state_dict."""
    out = dict(sd)
    for key in list(sd):
        if re.search(r"\.gamma_[12]\.gamma$", key):  # BEiT's LayerScales are bare tensors
            out[key[:-len(".gamma")]] = out.pop(key)
        elif key.endswith(".attn.q.weight"):  # BEiT: q, k, v
            base = key[:-len("q.weight")]
            out[f"{base}qkv.weight"] = torch.cat([out.pop(f"{base}{p}.weight") for p in "qkv"])
            out[f"{base}q_bias"] = out.pop(f"{base}q.bias")
            out[f"{base}v_bias"] = out.pop(f"{base}v.bias")
            # mde_tpu's class slots (cls-cls, cls-tok, tok-cls) -> timm's
            # (cls-tok, tok-cls, cls-cls)
            table = out[f"{base}relative_position_bias_table"]
            out[f"{base}relative_position_bias_table"] = torch.cat(
                [table[:-3], table[-3:][[1, 2, 0]]])
        elif key.endswith(".attn.logit_scale"):  # Swin V2: q and v biases
            base = key[:-len("logit_scale")]
            # timm's grammar has no k bias: mde_tpu's k third (zero at init,
            # trained by its V2) is dropped
            q, _, v = out.pop(f"{base}qkv.bias").chunk(3)
            out[f"{base}q_bias"], out[f"{base}v_bias"] = q, v
        elif key.endswith(".downsample.reduction.weight"):  # Swin: timm's 2x2 order
            out[key] = _groups(out[key], 4, (0, 2, 1, 3), dim=1)
            norm = key.replace("reduction.weight", "norm.")
            if out[f"{norm}weight"].numel() == out[key].shape[1]:  # V1 norms the 4C concat
                for leaf in ("weight", "bias"):
                    out[f"{norm}{leaf}"] = _groups(out[f"{norm}{leaf}"], 4, (0, 2, 1, 3))
        elif key.endswith(".m.q.c.weight"):  # LeViT attention: per-head [q|k|v]
            base = key[:-len("q.c.weight")]
            heads = sd[key].shape[0] // 32
            for leaf in ("c.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"):
                if f"{base}q.{leaf}" not in out:
                    continue
                q, kv = out.pop(f"{base}q.{leaf}"), out.pop(f"{base}kv.{leaf}")
                k, v = kv[:q.shape[0]], kv[q.shape[0]:]
                out[f"{base}qkv.{leaf}"] = _per_head(q, k, v, heads=heads)
        elif key.endswith(".q.1.c.weight"):  # LeViT subsample: per-head [k|v]
            base = key[:-len("q.1.c.weight")]
            heads = sd[key].shape[0] // 32
            for leaf in ("c.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"):
                if f"{base}kv.{leaf}" in out:
                    kv = out[f"{base}kv.{leaf}"]
                    k, v = kv[:sd[key].shape[0]], kv[sd[key].shape[0]:]
                    out[f"{base}kv.{leaf}"] = _per_head(k, v, heads=heads)
    return out


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
    return _fuse_dpt_trunk(out) if model == "DPTDepthModel" else out

"""Inference-time conv+BN folding on the port's state_dict (port of
mde_tpu/nn/fuse.py, the reference's ``fuse_model``,
src/network/midas_net_custom.py:188-207).

Each BatchNorm's affine and running statistics are folded into the
convolution before it, and the BN is replaced by an exact identity, so the
unchanged model in eval mode computes conv -> activation only:

  y = (conv(x, K) + b - mean) * scale / sqrt(var + eps) + bias_bn
    = conv(x, K * s_o) + (b - mean) * s_o + bias_bn,  s_o = scale_o / sqrt(var_o + eps)

per output channel o. The folded BN keeps weight 1, mean 0 and var 1 - eps
(so that sqrt(var + eps) is exactly 1), and its bias holds whatever shift
the conv has no bias for.

Pairs are found with mde_tpu's naming rules (fuse.py:33-44), written in the
reference grammar that the port's state_dict uses (train/convert.py):
``convN``/``bnN`` siblings; the gen-efficientnet blocks' ``conv_pw``/``bn1``,
``conv_dw``/``bn2``, ``conv_pwl``/``bn3`` (the stage-one depthwise-separable
blocks, which have no ``conv_pwl``: ``conv_dw``/``bn1``, ``conv_pw``/``bn2``);
and, in the Sequentials that the JAX modules name ``conv_stem``/``bn1``,
``shortcut_conv``/``shortcut_bn``, ``spatial_reduction`` ``convN``/``bnN`` and
``spatial_upsample_convN``/``_bnN``, a conv at index i with its BN at i + 1.
Epsilons as mde_tpu's: 1e-3 inside the TF-style EfficientNet trunk (the
module prefix of its ``layerL.S.R`` blocks), 1e-5 elsewhere.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional

import numpy as np
import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
# conv -> BN sibling names (last path segment) in a gen-efficientnet block
_INVERTED_RESIDUAL = {"conv_pw": "bn1", "conv_dw": "bn2", "conv_pwl": "bn3"}
_DEPTHWISE_SEPARABLE = {"conv_dw": "bn1", "conv_pw": "bn2"}
# Sequentials whose conv at index i pairs with the BN at i + 1
_SEQUENTIALS = ("shortcut", "spatial_reduction", "spatial_upsample")
# an EfficientNet block: <root>.layerL.S.R
_EFFNET_BLOCK = re.compile(r"^(?:(.*)\.)?layer\d+\.\d+\.\d+\.conv_dw\.weight$")
# transposed convolutions keep their output channels in dim 1: (I, O, H, W)
_TRANSPOSED = re.compile(r"(^|\.)spatial_upsample\.\d+$")


def _modules(state_dict) -> tuple[set, set]:
    """(conv module names, BN module names) of a state_dict."""
    convs = {k[:-len(".weight")] for k, v in state_dict.items()
             if k.endswith(".weight") and v.dim() == 4}
    bns = {k[:-len(".running_mean")] for k in state_dict if k.endswith(".running_mean")}
    return convs, bns


def _effnet_roots(state_dict) -> set:
    """Module prefixes that host a TF-style EfficientNet (BN eps 1e-3)."""
    return {m.group(1) or "" for m in map(_EFFNET_BLOCK.match, state_dict) if m}


def discover_conv_bn_pairs(state_dict) -> list[tuple[str, str]]:
    """(conv module, BN module) pairs of a reference-grammar state_dict, by
    mde_tpu's naming rules; sorted by conv name."""
    convs, bns = _modules(state_dict)
    roots = _effnet_roots(state_dict)
    pairs = []
    for conv in sorted(convs):
        parent, _, name = conv.rpartition(".")
        prefix = f"{parent}." if parent else ""
        bn = None
        if m := re.fullmatch(r"conv(\d+)", name):
            bn = f"bn{m[1]}"
        elif name in _INVERTED_RESIDUAL:
            rules = (_INVERTED_RESIDUAL if f"{prefix}conv_pwl" in convs
                     else _DEPTHWISE_SEPARABLE)
            bn = rules[name]
        elif name.isdigit():
            seq = parent.rpartition(".")[2]
            stem = any(parent == (f"{r}.layer1" if r else "layer1") for r in roots)
            if seq in _SEQUENTIALS or (stem and name == "0"):
                bn = str(int(name) + 1)
        if bn is not None and f"{prefix}{bn}" in bns:
            pairs.append((conv, f"{prefix}{bn}"))
    return pairs


def fold_conv_bn(state_dict, pairs: Optional[Iterable[tuple[str, str]]] = None,
                 eps_by_bn: Optional[dict] = None) -> dict:
    """A new state_dict with each BN of ``pairs`` (default:
    ``discover_conv_bn_pairs``) folded into its conv. ``eps_by_bn`` maps a BN
    module to its epsilon (default 1e-5; ``fuse_model_params`` knows the
    EfficientNet's 1e-3). The fold is computed in float64 and stored in each
    tensor's own dtype; tensors of no pair are the input's own."""
    pairs = list(pairs) if pairs is not None else discover_conv_bn_pairs(state_dict)
    eps_by_bn = dict(eps_by_bn or {})
    out = dict(state_dict)

    def f64(key):
        return state_dict[key].detach().cpu().double().numpy()

    def put(key, value):
        ref = state_dict[key]
        out[key] = torch.as_tensor(np.asarray(value)).to(dtype=ref.dtype, device=ref.device)

    for conv, bn in pairs:
        eps = float(eps_by_bn.get(bn, 1e-5))
        scale, bn_bias, mean, var = (f64(f"{bn}.{leaf}") for leaf in _BN_LEAVES)
        s = scale / np.sqrt(var + eps)
        kernel = f64(f"{conv}.weight")
        shape = [1] * kernel.ndim
        shape[1 if _TRANSPOSED.search(conv) else 0] = -1
        put(f"{conv}.weight", kernel * s.reshape(shape))
        if f"{conv}.bias" in state_dict:
            # everything into the conv's bias; the BN becomes the exact identity
            put(f"{conv}.bias", (f64(f"{conv}.bias") - mean) * s + bn_bias)
            new_bias = np.zeros_like(bn_bias)
        else:
            # a bias-free conv: the remaining shift stays in the BN, which is
            # then a bias add (weight 1, mean 0, var 1 - eps)
            new_bias = bn_bias - mean * s
        put(f"{bn}.weight", np.ones_like(scale))
        put(f"{bn}.bias", new_bias)
        put(f"{bn}.running_mean", np.zeros_like(mean))
        put(f"{bn}.running_var", np.full_like(var, 1.0 - eps))
    return out


def fuse_model_params(state_dict) -> dict:
    """``fuse_model`` for a whole model's state_dict: the pairs of
    ``discover_conv_bn_pairs``, each BN at its family's epsilon (1e-3 in the
    TF-style EfficientNet trunk, 1e-5 elsewhere)."""
    pairs = discover_conv_bn_pairs(state_dict)
    roots = _effnet_roots(state_dict)

    def eps_for(bn: str) -> float:
        return 1e-3 if any(r == "" or bn.startswith(f"{r}.") for r in roots) else 1e-5

    return fold_conv_bn(state_dict, pairs, {bn: eps_for(bn) for _, bn in pairs})

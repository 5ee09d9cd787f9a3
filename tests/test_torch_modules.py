"""The port's modules against their JAX counterparts, at float32 on the CPU.

Each JAX module is initialised at a small size, its BN running statistics and
LayerScale gammas are randomised (fresh ones are 0/1 and 1e-5, which would hide
a wrong mapping), and its weights are carried to the port's module through
``train/convert.py::state_dict_from_flax``. The same numpy inputs then go
through both.

Tolerance: rtol 1e-5, atol 1e-5. Both sides run the same float32 math in
another summation order: the largest gap measured is 3.6e-6 on the 12-block
ViT's O(1) tokens, and under 1e-6 elsewhere. A wrong weight layout or name is
off by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.models.midas_semantics import (
    CrossAttention as JCrossAttention,
    Dinov2Head as JDinov2Head,
    ResidualBlock as JResidualBlock,
)
from mde_tpu.nn.blocks import FeatureFusionBlockCustom as JFusion
from mde_tpu.nn.efficientnet import EfficientNetLite as JEffNet
from mde_tpu.nn.vit import ViT as JViT
from mde_tpu.ops.resize import resize_bicubic as j_bicubic, resize_bilinear as j_bilinear
from mde_tpu_torch.models.midas_semantics import (
    DEAD_KEY_PREFIXES,
    CrossAttention,
    Dinov2Head,
    ResidualBlock,
)
from mde_tpu_torch.nn.blocks import FeatureFusionBlockCustom
from mde_tpu_torch.models.dpt import DPTDepthModel
from mde_tpu_torch.nn.efficientnet import EfficientNetLite
from mde_tpu_torch.nn.registry import encoder_channels, make_encoder
from mde_tpu_torch.nn.resnext import ResNetBackbone
from mde_tpu_torch.nn.vit import ViT
from mde_tpu_torch.ops.resize import resize_bicubic, resize_bilinear
from mde_tpu_torch.train.checkpoint import load_state_dict
from mde_tpu_torch.train.convert import state_dict_from_flax

torch.set_num_threads(2)


def _randomize(tree, rng):
    """numpy copy of a flax tree with non-trivial BN stats and LayerScale gammas."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
            continue
        v = np.array(v, np.float32)
        if k == "mean":
            v = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k == "var":
            v = rng.uniform(0.75, 1.25, v.shape).astype(np.float32)
        elif k == "gamma":
            v = rng.uniform(0.2, 0.8, v.shape).astype(np.float32)
        out[k] = v
    return out


def _nest(tree, prefix):
    for k in reversed(prefix):
        tree = {k: tree}
    return tree


def _carry(jmodule, args, port, flax_prefix, torch_prefix, seed=0, **kw):
    """Init ``jmodule``, randomise, carry its weights into ``port``; returns the
    JAX variables to apply with."""
    variables = jax.jit(lambda key: jmodule.init(key, *args, **kw))(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = _randomize(variables["params"], rng)
    stats = _randomize(variables.get("batch_stats", {}), rng)
    sd = state_dict_from_flax(_nest(params, flax_prefix), _nest(stats, flax_prefix))
    assert all(k.startswith(torch_prefix) for k in sd), sorted(sd)[:3]
    report = load_state_dict(port, {k[len(torch_prefix):]: v for k, v in sd.items()})
    assert not report["unexpected"] and not report["shape_mismatch"], report
    dead = tuple(p[len(torch_prefix):] for p in DEAD_KEY_PREFIXES if p.startswith(torch_prefix))
    live_missing = [k for k in report["missing"]
                    if not k.endswith("num_batches_tracked") and not (dead and k.startswith(dead))]
    assert not live_missing, live_missing
    return {"params": params, "batch_stats": stats}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(11, 13), (4, 5)])
def test_resize_bilinear(align_corners, size):
    x = np.random.default_rng(6).standard_normal((2, 7, 9, 3)).astype(np.float32)
    got = resize_bilinear(_nchw(x), size, align_corners).numpy()
    want = j_bilinear(jnp.asarray(x), size, align_corners=align_corners)
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("grid", [(16, 20), (2, 3)])
def test_resize_bicubic_interpolate_offset(grid):
    """DINOv2's pos-embed resize: 37x37 -> (ph, pw), sampled at scale in/(out+0.1)."""
    x = np.random.default_rng(7).standard_normal((1, 37, 37, 8)).astype(np.float32)
    ph, pw = grid
    got = resize_bicubic(_nchw(x), grid, scale_factor=((ph + 0.1) / 37, (pw + 0.1) / 37))
    want = j_bicubic(jnp.asarray(x), grid, align_corners=False,
                     src_scales=(37 / (ph + 0.1), 37 / (pw + 0.1)))
    _close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))


def test_feature_fusion_block():
    rng = np.random.default_rng(0)
    x, skip = (rng.standard_normal((2, 6, 8, 32)).astype(np.float32) for _ in range(2))
    port = FeatureFusionBlockCustom(32, expand=True).eval()
    jm = JFusion(32, expand=True, align_corners=True)
    v = _carry(jm, (jnp.asarray(x), jnp.asarray(skip)), port, ("midas", "refinenet3"),
               "scratch.refinenet3.")
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, size=(11, 13)))(v, x, skip)
    with torch.no_grad():
        got = port(_nchw(x), _nchw(skip), size=(11, 13)).numpy()
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("merge_entry", [False, True])
def test_residual_block_with_projection(merge_entry):
    """The port's two convs vs the JAX block, whose merged entry (the TPU
    lowering, on in the flagship) keeps the same parameters."""
    x = np.random.default_rng(1).standard_normal((2, 9, 11, 64)).astype(np.float32)
    port = ResidualBlock(64, 32).eval()
    jm = JResidualBlock(32, merge_entry=merge_entry)
    v = _carry(jm, (jnp.asarray(x),), port, ("fusion_head_0",), "fusion_head.0.")
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))


def test_efficientnet_lite3():
    x = np.random.default_rng(2).standard_normal((2, 64, 96, 3)).astype(np.float32)
    port = EfficientNetLite("efficientnet_lite3").eval()
    jm = JEffNet("efficientnet_lite3")
    v = _carry(jm, (jnp.asarray(x),), port, ("midas", "pretrained"), "pretrained.", train=False)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        got = port(_nchw(x))
    assert [t.shape[1] for t in got] == [32, 48, 136, 384]
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2))


def test_vit_s14_at_28x42():
    """DINOv2 ViT-S/14 at a 2x3 token grid: the 37x37 pos-embed goes through
    the bicubic interpolate_offset resize; last 4 blocks, final LN, no cls."""
    x = np.random.default_rng(3).standard_normal((2, 28, 42, 3)).astype(np.float32)
    port = ViT("dinov2_vits14").eval()
    jm = JViT("dinov2_vits14")
    v = _carry(jm, (jnp.asarray(x),), port, ("dinov2",), "dinov2.", n_layers=4, train=False)
    want = jax.jit(lambda v, x: jm.apply(v, x, n_layers=4, train=False))(v, x)
    with torch.no_grad():
        got = port(_nchw(x), n_layers=4)
    assert len(got) == 4 and tuple(got[0].shape) == (2, 6, 384)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("hw", [(64, 96), (136, 200)])
def test_cross_attention(hw):
    """One ragged window (8x12 reduced grid) and four ragged windows (17x25)."""
    rng = np.random.default_rng(4)
    x, ctx = (rng.standard_normal((1,) + hw + (32,)).astype(np.float32) for _ in range(2))
    port = CrossAttention(32).eval()
    jm = JCrossAttention(32)
    v = _carry(jm, (jnp.asarray(x), jnp.asarray(ctx)), port, ("cross_attention",),
               "cross_attention.")
    want = jax.jit(jm.apply)(v, x, ctx)
    with torch.no_grad():
        got = port(_nchw(x), _nchw(ctx)).numpy()
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))


def test_dinov2_head():
    rng = np.random.default_rng(5)
    taps = [rng.standard_normal((2, 6, 384)).astype(np.float32) for _ in range(4)]
    port = Dinov2Head(384, 128).eval()
    jm = JDinov2Head(128)
    v = _carry(jm, ([jnp.asarray(t) for t in taps], 2, 3), port, ("dinov2_head",),
               "dinov2_head.")
    want = jm.apply(v, [jnp.asarray(t) for t in taps], 2, 3)
    with torch.no_grad():
        got = port([torch.from_numpy(t) for t in taps], 2, 3).numpy()
    assert got.shape == (2, 32, 28, 42)
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("model", ["beitl16_512", "swin2l24_384", "levit_384",
                                   "next_vit_large_6m"])
def test_unported_models_raise_with_their_roadmap_item(model):
    """The DPT trunks that only mde_tpu's model_loader reaches were ROADMAP
    item 6.6 and raised naming it; they are ported now: each builds (on the
    meta device) with a scratch conv a level of its width, and only a name
    outside ``DPT_BACKBONE_HOOKS`` raises, as mde_tpu's DPT does."""
    from mde_tpu_torch.models.dpt import DPT_BACKBONE_CHANNELS

    with torch.device("meta"):
        built = DPTDepthModel(model)
    widths = [getattr(built.scratch, f"layer{i + 1}_rn").in_channels
              for i in range(len(DPT_BACKBONE_CHANNELS[model]))]
    assert widths == list(DPT_BACKBONE_CHANNELS[model])
    with pytest.raises(NotImplementedError, match="is not implemented; available"):
        DPTDepthModel(model + "_v2")


def test_registry_has_only_the_flagship_encoder():
    """The registry's convolutional rows build (the flagship's lite3 and
    MidasNet's ResNeXt101); the token backbones go through models/dpt.py
    and raise here, as in mde_tpu."""
    assert encoder_channels("efficientnet_lite3") == [32, 48, 136, 384]
    assert encoder_channels("resnext101_wsl") == [256, 512, 1024, 2048]
    with torch.device("meta"):
        assert isinstance(make_encoder("resnext101_wsl"), ResNetBackbone)
        assert isinstance(make_encoder("efficientnet_lite0"), EfficientNetLite)
    for name in ("vitl16_384", "vitb_rn50_384", "beitl16_512"):
        with pytest.raises(NotImplementedError, match="models.dpt"):
            make_encoder(name)
    with pytest.raises(ValueError, match="not in registry"):
        encoder_channels("resnet50")

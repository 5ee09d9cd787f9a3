"""The zoo's modules in the port against the JAX package's, at float32 on the CPU.

DGR, every LocalBins layer (both attractor types and kinds, nA != n_bins,
the normed and unnormed seed regressors, LinearSplitter, log_binom at k = n),
MidasNet's ResidualConvUnit and FeatureFusionBlock, the grouped ResNeXt
bottleneck, StdConv's TF SAME padding, the ResNetV2 stem and the timm ViT's
raw taps at a grid off its 24x24 pos-embed. Each JAX module is initialised at
a small size with its BN statistics randomised, its weights carried to the
port through ``state_dict_from_flax`` (under the flax path the module has in
its model), and the same numpy inputs go through both.

Tolerance: rtol 1e-5, atol 1e-5, as tests/test_torch_modules.py: the same
float32 math in another summation order. A wrong layout, axis or padding is
off by O(1e-2) or more. LocalBins' attractors sum 300 / (1 + 300 dx^2)-sized
terms; its tolerance is stated where it differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mde_tpu.models import localbins as jlb
from mde_tpu.models.midas_small import DGR as JDGR
from mde_tpu.nn import resnetv2 as jrv2
from mde_tpu.nn import vit as jvit
from mde_tpu.nn.blocks import FeatureFusionBlock as JFFB, ResidualConvUnit as JRCU
from mde_tpu.nn.resnext import Bottleneck as JBottleneck
from mde_tpu_torch.models import localbins as lb
from mde_tpu_torch.models.midas_small import DGR
from mde_tpu_torch.nn import vit
from mde_tpu_torch.nn.blocks import FeatureFusionBlock, ResidualConvUnit, init_weights_
from mde_tpu_torch.nn.resnetv2 import ResNetV2Stem, StdConv
from mde_tpu_torch.nn.resnext import Bottleneck
from mde_tpu_torch.train.checkpoint import load_state_dict
from mde_tpu_torch.train.convert import state_dict_from_flax
from tests.test_torch_modules import _nchw, _nest, _randomize

torch.set_num_threads(2)


def carry(jmodule, args, port, model, flax_prefix, torch_prefix, seed=0, dead=(), **kw):
    """Init ``jmodule``, randomise its BN statistics, carry its weights into
    ``port`` through ``state_dict_from_flax(..., model)`` with the module at
    ``flax_prefix`` of ``model``'s tree. Every key of ``port`` is set but its
    constant buffers (DGR's taps, LogBinomial's) and the ``dead`` prefixes.
    Returns the JAX variables."""
    variables = jax.jit(lambda key: jmodule.init(key, *args, **kw))(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = _randomize(variables["params"], rng)
    stats = _randomize(variables.get("batch_stats", {}), rng)
    sd = state_dict_from_flax(_nest(params, flax_prefix), _nest(stats, flax_prefix), model)
    assert all(k.startswith(torch_prefix) for k in sd), sorted(sd)[:3]
    report = load_state_dict(port, {k[len(torch_prefix):]: v for k, v in sd.items()})
    assert not report["unexpected"] and not report["shape_mismatch"], report
    constants = {k for k, _ in port.named_buffers() if not k.endswith(("running_mean", "running_var"))}
    unset = [k for k in report["missing"] if k not in constants and not k.startswith(dead or "\0")]
    assert not unset, unset
    return {"params": params, "batch_stats": stats}


def close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def rand(rng, *shape, low=-1.0, high=1.0):
    return rng.uniform(low, high, shape).astype(np.float32)


def port_module(cls, *args, seed=0, **kw):
    """The port's module with every leaf set from a generator (constants too)."""
    return init_weights_(cls(*args, **kw), torch.Generator().manual_seed(seed)).eval()


# ---------------------------------------------------------------------------
# DGR
# ---------------------------------------------------------------------------


def test_dgr():
    """Laplacian pair (frozen constants), recalibration with exact GELU,
    depthwise spatial conv over 3c, first c channels plus x."""
    x = rand(np.random.default_rng(0), 2, 9, 11, 16)
    port = port_module(DGR, 16)
    jm = JDGR()
    v = carry(jm, (jnp.asarray(x),), port, "MidasNetSmall", ("dgr2",), "dgr2.")
    with torch.no_grad():
        got = nhwc(port(_nchw(x)))
    close(got, jm.apply(v, jnp.asarray(x)))
    # the Laplacian taps are buffers, not parameters: no optimizer or count sees them
    assert {n for n, _ in port.named_parameters()} == {
        "recalib.1.weight", "recalib.1.bias", "recalib.3.weight", "recalib.3.bias",
        "spatial.weight", "spatial.bias"}
    lap = torch.tensor([[0.0, 1, 0], [1, -4, 1], [0, 1, 0]])
    assert torch.equal(port.lap2.weight[3, 0], lap) and torch.equal(port.lap3.weight[3, 0], lap * lap)


# ---------------------------------------------------------------------------
# LocalBins layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normed", [False, True])
def test_seed_bin_regressor(normed):
    x = rand(np.random.default_rng(1), 2, 4, 5, 24)
    jcls, cls = ((jlb.SeedBinRegressor, lb.SeedBinRegressor) if normed
                 else (jlb.SeedBinRegressorUnnormed, lb.SeedBinRegressorUnnormed))
    jm, port = jcls(n_bins=12, mlp_dim=32), port_module(cls, 24, 12, 32)
    v = carry(jm, (jnp.asarray(x),), port, "MidasNetSmall", ("local_bins", "seed_bin_regressor"),
              "local_bins.seed_bin_regressor.")
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    for g, w in zip(got, want):
        close(nhwc(g), w)
    if normed:  # centers inside (min_depth, max_depth), increasing along the bins
        c = got[1]
        assert (c > 1e-3).all() and (c < 10).all() and (c.diff(dim=1) > 0).all()


def test_projector():
    x = rand(np.random.default_rng(2), 2, 4, 5, 24)
    jm, port = jlb.Projector(out_features=20, mlp_dim=16), port_module(lb.Projector, 24, 20, 16)
    v = carry(jm, (jnp.asarray(x),), port, "MidasNetSmall", ("local_bins", "projectors_1"),
              "local_bins.projectors.1.")
    with torch.no_grad():
        close(nhwc(port(_nchw(x))), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("attractor_type", ["exp", "inv"])
@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_attractor_layer(attractor_type, kind):
    """nA = 5 attractors against 12 bins: the delta sums over the attractor
    axis (1 in NCHW), which a reduction over the bins would get wrong. The
    previous embedding and centers come at half the resolution (resized
    align-corners). ``b_prev`` spans [0, 0.3] around the softplus
    attractors so the 300-sharp terms are neither saturated nor zero."""
    rng = np.random.default_rng(3)
    x = rand(rng, 2, 8, 10, 16)
    b_prev = rand(rng, 2, 4, 5, 12, low=0.0, high=0.3)
    emb = rand(rng, 2, 4, 5, 16)
    jm = jlb.AttractorLayerUnnormed(n_bins=12, n_attractors=5, mlp_dim=16, kind=kind,
                                    attractor_type=attractor_type)
    port = port_module(lb.AttractorLayerUnnormed, 16, 12, 5, 16, kind=kind,
                       attractor_type=attractor_type)
    args = tuple(jnp.asarray(a) for a in (x, b_prev, emb))
    v = carry(jm, args, port, "MidasNetSmall", ("local_bins", "attractors_0"),
              "local_bins.attractors.0.")
    want = jm.apply(v, *args)
    with torch.no_grad():
        got = port(_nchw(x), _nchw(b_prev), _nchw(emb))
    for g, w in zip(got, want):
        close(nhwc(g), w)
    assert got[0].shape == (2, 12, 8, 10) and port._net[2].out_channels == 5


def test_linear_splitter():
    rng = np.random.default_rng(4)
    x = rand(rng, 2, 6, 8, 16)
    b_prev = rand(rng, 2, 3, 4, 6, low=0.1, high=1.0)
    jm = jlb.LinearSplitter(prev_nbins=6, split_factor=3, mlp_dim=16)
    port = port_module(lb.LinearSplitter, 16, 6, 3, 16)
    args = (jnp.asarray(x), jnp.asarray(b_prev))
    v = carry(jm, args, port, "MidasNetSmall", ("local_bins", "attractors_1"),
              "local_bins.attractors.1.")
    want = jm.apply(v, *args)
    with torch.no_grad():
        got = port(_nchw(x), _nchw(b_prev))
    for g, w in zip(got, want):
        close(nhwc(g), w)
    assert got[1].shape == (2, 18, 6, 8)


def test_log_binom_at_k_equal_n():
    """k = n is finite (0 up to eps terms) in both, thanks to the clamp."""
    n = torch.tensor(15.0)
    k = torch.arange(16.0)
    got = lb.log_binom(n, k).numpy()
    want = np.asarray(jlb.log_binom(jnp.float32(15.0), jnp.arange(16.0)))
    assert np.isfinite(got).all()
    close(got, want)
    assert abs(got[-1]) < 1e-4 and abs(got[0]) < 1e-4
    # the clamp: n - k below 0 by rounding would be log(negative) without it
    assert torch.isfinite(lb.log_binom(n, n + 1e-6)).all()


def test_log_binomial_and_conditional():
    rng = np.random.default_rng(5)
    p = rand(rng, 2, 5, 6, low=0.0, high=1.0)
    p[0, 0, :3] = (0.0, 1.0, 1e-6)  # the clip edges
    t = rand(rng, 2, 5, 6, 1, low=0.5, high=3.0)
    port = port_module(lb.LogBinomial, 16)
    with torch.no_grad():
        got = nhwc(port(torch.from_numpy(p), _nchw(t)))
    want = jlb.LogBinomial(16).apply({}, jnp.asarray(p), jnp.asarray(t))
    close(got, want)
    assert port.k_idx.dtype == torch.int64 and port.k_idx.flatten().tolist() == list(range(16))
    assert port.K_minus_1.item() == 15.0

    x, cond = rand(rng, 2, 5, 6, 2), rand(rng, 2, 5, 6, 24)
    jm = jlb.ConditionalLogBinomial(n_classes=16, min_temp=5.0, max_temp=50.0)
    cport = port_module(lb.ConditionalLogBinomial, 2, 24, 16, min_temp=5.0, max_temp=50.0)
    args = (jnp.asarray(x), jnp.asarray(cond))
    v = carry(jm, args, cport, "MidasNetSmall", ("local_bins", "conditional_log_binomial"),
              "local_bins.conditional_log_binomial.")
    with torch.no_grad():
        got = nhwc(cport(_nchw(x), _nchw(cond)))
    close(got, jm.apply(v, *args))
    close(got.sum(-1), np.ones(got.shape[:-1]))


def test_localbins_block():
    """The whole head on a pyramid at MiDaS-small's ratios (scaled widths)."""
    rng = np.random.default_rng(6)
    h, w = 3, 4
    ch = (32, 16, 8, 8, 8)
    shapes = [(2, 16 * h, 16 * w, 1), (2, h, w, ch[0]), (2, 2 * h, 2 * w, ch[1]),
              (2, 4 * h, 4 * w, ch[2]), (2, 8 * h, 8 * w, ch[3]), (2, 8 * h, 8 * w, ch[4])]
    feats = [rand(rng, *s) for s in shapes]
    feats[0] = np.abs(feats[0])
    rel = feats[0][..., 0]
    jm = jlb.LocalBinsBlock()
    port = port_module(lb.LocalBinsBlock, ch)
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(rel))
    v = carry(jm, args, port, "MidasNetSmall", ("local_bins",), "local_bins.")
    want = np.asarray(jm.apply(v, *args))
    with torch.no_grad():
        got = port([_nchw(f) for f in feats], torch.from_numpy(rel)).numpy()
    assert got.shape == (2, 16 * h, 16 * w) and np.isfinite(got).all()
    # 1e-4 relative: four attractor stages of 300-sharp terms and a 16-way softmax
    close(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# MidasNet's fusion blocks, the ResNeXt bottleneck
# ---------------------------------------------------------------------------


def test_residual_conv_unit_adds_the_relu_input():
    x = rand(np.random.default_rng(7), 2, 6, 7, 8)
    jm, port = JRCU(8), port_module(ResidualConvUnit, 8)
    v = carry(jm, (jnp.asarray(x),), port, "MidasNet", ("refinenet2", "resConfUnit2"),
              "scratch.refinenet2.resConfUnit2.")
    with torch.no_grad():
        got = nhwc(port(_nchw(x)))
        h = F.relu(_nchw(x))
        assert np.abs(got - nhwc(port.conv2(F.relu(port.conv1(h))) + h)).max() == 0
    close(got, jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("inputs", [1, 2])
def test_feature_fusion_block(inputs):
    rng = np.random.default_rng(8)
    xs = [rand(rng, 2, 5, 7, 8) for _ in range(inputs)]
    jm, port = JFFB(8), port_module(FeatureFusionBlock, 8)
    v = carry(jm, tuple(jnp.asarray(a) for a in xs), port, "MidasNet", ("refinenet3",),
              "scratch.refinenet3.", dead=("resConfUnit1.",) if inputs == 1 else ())
    with torch.no_grad():
        got = nhwc(port(*(_nchw(a) for a in xs)))
    assert got.shape == (2, 10, 14, 8)
    close(got, jm.apply(v, *(jnp.asarray(a) for a in xs)))


@pytest.mark.parametrize("stride,cin", [(1, 64), (2, 64), (1, 128)])
def test_resnext_bottleneck(stride, cin):
    """Grouped 3x3 (4 groups of width 8 here; 32 x 8 in ResNeXt101's first
    stage), with and without the downsample shortcut."""
    x = rand(np.random.default_rng(9), 2, 9, 10, cin)
    jm = JBottleneck(32, stride, groups=4, base_width=16)
    port = port_module(Bottleneck, cin, 32, stride, 4, 16)
    assert port.conv2.groups == 4 and port.conv2.weight.shape == (32, 8, 3, 3)
    assert (port.downsample is None) == (stride == 1 and cin == 128)
    v = carry(jm, (jnp.asarray(x),), port, "MidasNet", ("pretrained", "layer2_1"),
              "pretrained.layer2.1.")
    with torch.no_grad():
        close(nhwc(port(_nchw(x))), jm.apply(v, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# ResNetV2: StdConv's TF SAME padding, the stem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(9, 11), (8, 10)])
@pytest.mark.parametrize("k,stride", [(3, 2), (7, 2), (1, 2), (3, 1)])
def test_std_conv_tf_same(size, k, stride):
    """Odd and even sides at stride 2: TF SAME pads the extra pixel on the
    high side (odd sides pad symmetrically at k=3), where torch's symmetric
    padding would shift the grid."""
    x = rand(np.random.default_rng(10), 2, *size, 6)
    jm = jrv2.StdConv(5, k, stride)
    v = jax.jit(lambda key: jm.init(key, jnp.asarray(x)))(jax.random.key(0))
    kernel = np.asarray(v["params"]["kernel"]) * 3.0 + 0.1  # mean and scale to standardise away
    port = StdConv(6, 5, k, stride).eval()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = nhwc(port(_nchw(x)))
        var, mean = torch.var_mean(port.weight, dim=(1, 2, 3), unbiased=False, keepdim=True)
        std = (port.weight - mean) / torch.sqrt(var + 1e-6)
        symmetric = nhwc(F.conv2d(_nchw(x), std, None, stride, k // 2))
    want = np.asarray(jm.apply({"params": {"kernel": kernel}}, jnp.asarray(x)))
    close(got, want)
    if stride == 2 and k > 1 and size[0] % 2 == 0:
        assert got.shape != symmetric.shape or np.abs(got - symmetric).max() > 1e-2


def test_resnetv2_stem():
    """Stages (2, 1, 1) at 64x96 (even sides: the asymmetric pads), each
    stage's output against mde_tpu's. Tolerance: rtol 1e-4 and an atol of
    2e-5 of the stage's largest value: flax's GroupNorm takes the variance
    as E[x^2] - E[x]^2, which loses float32 digits where a group's mean is
    large, and the pre-activation stages grow to |x| ~ 10-20."""
    x = rand(np.random.default_rng(11), 2, 64, 96, 3, low=-1.5, high=1.5)
    jm, port = jrv2.ResNetV2Stem(layers=(2, 1, 1)), port_module(ResNetV2Stem, (2, 1, 1))
    v = carry(jm, (jnp.asarray(x),), port, "DPTDepthModel", ("pretrained_resnet",),
              "pretrained.model.patch_embed.backbone.")
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    for si, (g, w) in enumerate(zip(got, want)):
        assert g.shape[1] == 256 * 2**si
        close(nhwc(g), w, rtol=1e-4, atol=2e-5 * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# The timm ViT
# ---------------------------------------------------------------------------


def test_timm_vit_raw_taps(monkeypatch):
    """vitb16_384 narrowed (in both packages) to 64 wide, 12 blocks of 4
    heads; a 4x5 token grid, so the 24x24 pos-embed is resized bilinear
    (align_corners=False); the raw taps keep the class token and skip the
    final norm. No LayerScale, no mask_token."""
    monkeypatch.setitem(jvit.VIT_CONFIGS, "vitb16_384", (64, 12, 4, 16))
    monkeypatch.setitem(vit.VIT_CONFIGS, "vitb16_384", (64, 12, 4, 16))
    x = rand(np.random.default_rng(12), 2, 64, 80, 3, low=-1.5, high=1.5)
    jm = jvit.ViT("vitb16_384", pos_grid=(24, 24), layerscale=False)
    port = port_module(vit.ViT, "vitb16_384")
    assert not any("ls1" in k or "mask_token" in k for k in port.state_dict())
    hooks = (2, 5, 8, 11)
    v = carry(jm, (jnp.asarray(x),), port, "DPTDepthModel", ("pretrained",), "pretrained.model.",
              dead=("norm.",), out_indices=hooks, raw_taps=True)
    rng = np.random.default_rng(13)
    v["params"]["pos_embed"] = rng.normal(0, 0.5, v["params"]["pos_embed"].shape).astype(np.float32)
    with torch.no_grad():
        port.pos_embed.copy_(torch.from_numpy(v["params"]["pos_embed"]))
        got = port(_nchw(x), out_indices=hooks, raw_taps=True)
    want = jax.jit(lambda v, a: jm.apply(v, a, out_indices=hooks, raw_taps=True))(v, jnp.asarray(x))
    assert len(got) == 4 and got[0].shape == (2, 21, 64)
    for g, w in zip(got, want):
        close(g.numpy(), w)
    with torch.no_grad():  # a bicubic (DINOv2) resize would not match
        bicubic = port._patch_pos(4, 5)
        port.dinov2 = True
        assert (port._patch_pos(4, 5) - bicubic).abs().max() > 1e-3

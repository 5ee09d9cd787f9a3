"""The port's BEiT, Swin V1/V2, LeViT and Next-ViT trunks and the nine DPTs
over them against the JAX package, at float32 on the CPU.

BEiT and Swin are narrowed in both packages (``monkeypatch.setitem`` on
``BEIT_CONFIGS`` and ``SWIN_CONFIGS``, as tests/test_torch_zoo_models.py
narrows ViT-L) at their depths and hooks; LeViT and Next-ViT run at full
width, LeViT's trunk alone and Next-ViT's DPT on 64x64 inputs, LeViT's DPT
at 128x128 (at 64x64 its last stage holds one token a sample, and
BN's training-mode gradients over two tokens part between the packages, by
more than the gradient's norm). The narrowed rows cover a BEiT grid other
than its pretraining grid (the bias table resized) and one equal to it (the
index buffer), Swin windows smaller than the stage grid (shifted windows
with their masks) and a V1 window clamped to a grid smaller than it.

- The index, offset and mask helpers against mde_tpu's (BEiT's class slots in
  timm's order, V2's offsets a table rather than a pair map).
- Each trunk against mde_tpu's on the same weights (``state_dict_from_flax``)
  and numpy inputs from a seed: BEiT's raw taps, Swin's four stage maps,
  LeViT's three (Next-ViT's through its DPT, below).
- Each of the nine DPTs of ``model_loader.DEFAULT_MODELS`` whole: the forward
  against the JAX module at rtol 1e-4, atol 1e-5 and corrcoef > 0.9999
  (largest gap measured: 1.8e-5, the narrowed Swin2-B, whose window of 8
  and logit scales up to the clamp at 100 sharpen the cosine softmax, on a
  map up to 0.62; BEiT and LeViT 6.0e-8, Next-ViT 3.0e-7); the state_dict
  equal in keys and shapes to the reference builds of tests/torch_beit_ref.py,
  tests/torch_swin_ref.py (the trunk; it has no DPT) and
  tests/torch_levit_ref.py (at 224x224, its fixed geometry); a round trip
  through ``import_state_dict`` with the JAX map filling every leaf (Swin V2
  through ``_preprocess_swin_v2``), the model's dead keys left unmapped, each
  tensor given back exactly by ``state_dict_from_flax``. Next-ViT has no
  reference grammar or map: it is held through ``state_dict_from_flax``
  alone. LeViT's map is written for 224x224 (its bias-offset order), so its
  round trip is at that size with the JAX tree from ``jax.eval_shape``.
- mde_tpu's head options (``non_negative=False``, ``head_out_1=False``)
  against JAX on the narrowed BEiT-B DPT.
- One float32 train step a family through ``make_train_step(plain=True)``
  (BN in training mode) on post-pipeline inputs, the loss against JAX's
  ``combined_loss`` at rtol 1e-4 and the gradient within 0.15 rel-L2 (the
  noise band of tests/test_train_parity.py:444-457); Next-ViT's is marked
  slow (its JAX backward compiles for 25 s). LeViT's map is 6 pixels
  short of its input, so JAX's side resizes it to the target as the port's
  step does (train/trainer.py::_at_target).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.losses import combined_loss as jax_combined_loss
from mde_tpu.models.dpt import DPTDepthModel as JDPT
from mde_tpu.nn import beit as jbeit
from mde_tpu.nn import levit as jlevit
from mde_tpu.nn import next_vit as jnext_vit
from mde_tpu.nn import swin as jswin
from mde_tpu.ops.resize import resize_bilinear as jresize
from mde_tpu.train import torch_import as ti
from mde_tpu_torch.models.dpt import DPTDepthModel
from mde_tpu_torch.models.model_loader import DEFAULT_MODELS
from mde_tpu_torch.nn import beit, levit, next_vit, swin
from mde_tpu_torch.nn.blocks import init_weights_
from mde_tpu_torch.parallel import launch
from mde_tpu_torch.tools.common import parse_config
from mde_tpu_torch.train.checkpoint import load_state_dict
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.train.trainer import make_optimizer, make_train_step, step_generator
from tests.test_torch_modules import _nchw, _randomize
from tests.torch_beit_ref import BeitTrunk
from tests.torch_dpt_ref import DPTTorch
from tests.torch_levit_ref import DPTLevitTorch
from tests.torch_swin_ref import SwinTorch, SwinTorchV2

torch.set_num_threads(2)

# (dim, depth, heads, patch, pretrain grid): 64x96 inputs give a 4x6 grid
NARROW_BEIT = {"beitb16_384": (32, 12, 2, 16, (3, 3)), "beitl16_384": (32, 24, 2, 16, (4, 6)),
               "beitl16_512": (32, 24, 2, 16, (5, 5))}
# (version, embed, depths, heads, window): 64x128 inputs give stage grids
# 16x32 .. 2x4, so windows of 2, 4 and 8 shift, and the last stage clamps
NARROW_SWIN = {"swinl12_384": (1, 16, (2, 2, 2, 2), (1, 2, 2, 4), 4),
               "swin2l24_384": (2, 16, (2, 2, 2, 2), (1, 2, 2, 4), 4),
               "swin2b24_384": (2, 16, (2, 2, 2, 2), (2, 2, 4, 4), 8),
               "swin2t16_256": (2, 16, (2, 2, 2, 2), (1, 2, 2, 4), 2)}
SIZE = {"beit": (64, 96), "swin": (64, 128), "levit_384": (128, 128),
        "next_vit_large_6m": (64, 64)}
NINE = [n for n, (spec, _, _) in DEFAULT_MODELS.items()
        if isinstance(spec, dict) and not spec["backbone"].startswith("vit")]


@pytest.fixture(autouse=True)
def narrow(monkeypatch):
    for table in (jbeit.BEIT_CONFIGS, beit.BEIT_CONFIGS):
        for k, v in NARROW_BEIT.items():
            monkeypatch.setitem(table, k, v)
    for table in (jswin.SWIN_CONFIGS, swin.SWIN_CONFIGS):
        for k, v in NARROW_SWIN.items():
            monkeypatch.setitem(table, k, v)


def _size(backbone):
    return SIZE.get(backbone, SIZE.get(backbone[:4]))


def _spec(name):
    spec = dict(DEFAULT_MODELS[name][0])
    return spec.pop("backbone"), spec


_BUILT = {}


def built(name):
    """(JAX module, params, stats, port with the JAX weights, jitted JAX
    forward, input size) of a ``DEFAULT_MODELS`` DPT, once. The weights come
    from the JAX init with BN statistics and gammas randomised and the final
    depth bias raised by 0.5, so the last ReLU passes most of the map."""
    if name not in _BUILT:
        backbone, kw = _spec(name)
        size = _size(backbone)
        jm = JDPT(backbone=backbone, **kw)
        params, stats = _jax_weights(jm, size, np.random.default_rng(0))
        params["head_conv4"]["Conv_0"]["bias"] += 0.5
        port = init_weights_(DPTDepthModel(backbone, input_size=size, **kw),
                             torch.Generator().manual_seed(0)).eval()
        report = load_state_dict(port, state_dict_from_flax(params, stats, "DPTDepthModel"))
        assert not report["unexpected"] and not report["shape_mismatch"], report
        unset = [k for k in report["missing"] if not _dead(port, k)]
        assert not unset, unset
        _BUILT[name] = jm, params, stats, port, jax.jit(
            lambda p, s, a: jm.apply({"params": p, "batch_stats": s}, a)), size
    return _BUILT[name]


def _jax_weights(module, size, rng, **kw):
    """(params, batch_stats) of a JAX module at input ``size``, drawn from
    ``rng`` on the tree of ``jax.eval_shape`` (a jitted init of Next-ViT-L
    compiles for 20 s): kernels uniform in +-1/sqrt(fan_in) as torch's
    default, biases and norm shifts near 0, norm scales near 1, BN statistics
    and gammas as ``_randomize`` draws them, and bias tables and logit scales
    that are not all alike, so a slot or an offset out of place shows."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, *size, 3)),
                                                **kw))

    def draw(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = draw(v)
                continue
            shape = v.shape
            if k == "kernel":
                bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
                a = rng.uniform(-bound, bound, shape)
            elif k == "scale":
                a = rng.uniform(0.8, 1.2, shape)
            elif k in ("relative_position_bias_table", "attention_biases"):
                a = rng.normal(0, 0.5, shape)
            elif k == "logit_scale":
                a = rng.uniform(1.5, 5.0, shape)
            elif k == "cls_token":
                a = rng.normal(0, 0.02, shape)
            else:  # biases; BN statistics and gammas are redrawn below
                a = rng.uniform(-0.05, 0.05, shape)
            out[k] = a.astype(np.float32)
        if "logit_scale" in out:
            # Swin V2: the reference grammar has no k bias; mde_tpu's qkv
            # bias starts with a zero k third (train/convert.py drops it)
            c = out["qkv"]["bias"].shape[0] // 3
            out["qkv"]["bias"][c:2 * c] = 0
        return out

    return (_randomize(draw(dict(shapes["params"])), rng),
            _randomize(draw(dict(shapes.get("batch_stats", {}))), rng))


def _dead(model, key):
    return key.startswith(model.DEAD_KEY_PREFIXES) or key.endswith("num_batches_tracked")


def _x(size, seed=1, b=2):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (b, *size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# Helpers against mde_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(3, 3), (4, 6), (1, 2)])
def test_beit_index_is_mde_tpus_with_timms_class_slots(grid):
    want = jbeit._relative_position_index(*grid)
    got = beit._relative_position_index(*grid).numpy()
    num_rel = (2 * grid[0] - 1) * (2 * grid[1] - 1)
    np.testing.assert_array_equal(got[1:, 1:], want[1:, 1:])
    # timm's slots (cls-tok, tok-cls, cls-cls) hold mde_tpu's (cls-cls, cls-tok, tok-cls)
    to_mde = {num_rel: num_rel + 1, num_rel + 1: num_rel + 2, num_rel + 2: num_rel}
    np.testing.assert_array_equal(np.vectorize(lambda i: to_mde.get(i, i))(got), want)


@pytest.mark.parametrize("window", [1, 2, 7, 24])
def test_swin_offsets_and_masks_are_mde_tpus(window):
    idx = swin._v1_rel_index(window)
    np.testing.assert_array_equal(idx, jswin._v1_rel_index(window))
    # V2: the table row of each pair's offset holds mde_tpu's coordinates
    # exactly, as its float32 parameters see them (jnp.asarray of float64)
    np.testing.assert_array_equal(swin._v2_log_coords(window)[idx],
                                  np.asarray(jnp.asarray(jswin._v2_log_coords(window))))
    for h, w in ((4 * window, 2 * window), (2 * window, 2 * window)):
        got, want = swin._shift_mask(h, w, window, window // 2), jswin._shift_mask(
            h, w, window, window // 2)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid,stride", [((14, 14), 1), ((7, 7), 2), ((4, 6), 1), ((5, 3), 2)])
def test_levit_bias_index_is_mde_tpus(grid, stride):
    for got, want in zip(levit._bias_index(*grid, stride), jlevit._bias_index(*grid, stride)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The trunks alone
# ---------------------------------------------------------------------------

def _trunk_case(kind):
    """(JAX trunk, its call, port trunk, input size) of one trunk."""
    if kind.startswith("beit"):
        variant = kind
        hooks = (2, 5, 8, 11) if variant == "beitb16_384" else (5, 11, 17, 23)
        return (jbeit.BEiT(variant), functools.partial(_call, out_indices=hooks),
                beit.BEiT(variant), lambda m, x: m(x, hooks)[0], (64, 96))
    if kind.startswith("swin"):
        return (jswin.SwinBackbone(kind), _call, swin.SwinBackbone(kind, (64, 128)),
                lambda m, x: m(x), (64, 128))
    if kind == "levit":
        return jlevit.LeViT(), _call, levit.LeViT((64, 64)), lambda m, x: m(x), (64, 64)
    return jnext_vit.NextViT(), _call, next_vit.NextViT(), lambda m, x: m(x), (64, 64)


def _call(module, variables, x, **kw):
    return module.apply(variables, x, **kw)


# Next-ViT's trunk is held by its DPT's forward at the same 64x64 and width
TRUNKS = ["beitb16_384", "beitl16_384", "swinl12_384", "swin2b24_384", "levit"]


@pytest.mark.parametrize("kind", TRUNKS)
def test_trunk_matches_jax(kind):
    jm, jcall, port, pcall, size = _trunk_case(kind)
    kw = {"out_indices": (0,)} if kind.startswith("beit") else {}
    params, stats = _jax_weights(jm, size, np.random.default_rng(5), **kw)
    sd = state_dict_from_flax({"pretrained": params}, {"pretrained": stats} if stats else None,
                              "DPTDepthModel")
    sd = {k[len("pretrained.model."):]: v for k, v in sd.items()}
    init_weights_(port, torch.Generator().manual_seed(0)).eval()
    report = load_state_dict(port, sd)
    assert not report["unexpected"] and not report["shape_mismatch"], report
    assert all(k.endswith(("num_batches_tracked", "relative_position_index",
                           "attention_bias_idxs")) or k.startswith(tuple(
                               f"blocks.{i}." for i in range(22, 28))) for k in report["missing"])
    x = _x(size, seed=4)
    want = jcall(jm, {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = pcall(port, _nchw(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if w.ndim == 3 else g.permute(0, 2, 3, 1).numpy()  # tokens, or NCHW maps
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# The nine DPTs whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NINE)
def test_dpt_forward_matches_jax(name):
    _, params, stats, port, japply, size = built(name)
    x = _x(size)
    want = np.asarray(japply(params, stats, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
        plain = port(_nchw(x), plain=True).numpy()
    assert got.shape == want.shape
    assert float(want.std()) > 1e-3 and (want > 0).mean() > 0.5  # not clipped to a constant
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    np.testing.assert_array_equal(plain, got)  # these trunks launch no kernel


@pytest.mark.parametrize("non_negative,head_out_1", [(False, True), (True, False)])
def test_head_options_match_jax(non_negative, head_out_1):
    """mde_tpu's head options on the narrowed BEiT-B DPT: no final ReLU, and
    the head stopped before its 1x1 (the head_features_2 maps, NCHW here)."""
    jm = JDPT(backbone="beitb16_384", non_negative=non_negative, head_out_1=head_out_1)
    params, stats = _jax_weights(jm, SIZE["beit"], np.random.default_rng(7))
    port = init_weights_(DPTDepthModel("beitb16_384", non_negative=non_negative,
                                       head_out_1=head_out_1),
                         torch.Generator().manual_seed(0)).eval()
    report = load_state_dict(port, state_dict_from_flax(params, stats, "DPTDepthModel"))
    assert not report["unexpected"] and not report["shape_mismatch"], report
    assert not [k for k in report["missing"] if not _dead(port, k)]
    x = _x(SIZE["beit"], seed=3)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    if not head_out_1:
        got = got.transpose(0, 2, 3, 1)
        assert got.shape[-1] == 32
    else:
        assert (want < 0).any()  # no final ReLU
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _reference(name):
    """The reference build of a DPT's grammar, or of its trunk, with the
    port's keys it covers: (reference state_dict shapes, port prefix)."""
    backbone, kw = _spec(name)
    if backbone.startswith("beit"):
        dim, depth, heads, patch, grid = NARROW_BEIT[backbone]
        ref = DPTTorch(256, dim, depth, heads, hooks=(), out_channels=(
            jax_dpt_channels(backbone)))
        ref.pretrained.model = BeitTrunk(dim, depth, heads, patch, grid)
        return ref, ""
    if backbone.startswith("swin"):
        version, embed, depths, heads, window = NARROW_SWIN[backbone]
        return (SwinTorch if version == 1 else SwinTorchV2)(embed, depths, heads, window), \
            "pretrained.model."
    return DPTLevitTorch(), ""


def jax_dpt_channels(backbone):
    from mde_tpu.models.dpt import DPT_BACKBONE_CHANNELS

    return DPT_BACKBONE_CHANNELS[backbone]


@pytest.mark.parametrize("name", [n for n in NINE if "next_vit" not in n])
def test_state_dict_is_the_reference_grammar(name):
    """Keys and shapes of the reference build, dead keys included (Swin: its
    trunk; LeViT at 224x224, the reference's fixed geometry)."""
    backbone, kw = _spec(name)
    ref, prefix = _reference(name)
    size = (224, 224) if backbone == "levit_384" else None
    with torch.device("meta"):
        want = {prefix + k: tuple(v.shape) for k, v in ref.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in
               DPTDepthModel(backbone, input_size=size, **kw).state_dict().items()
               if k.startswith(prefix)}
    assert got == want


def _jax_map(backbone):
    if backbone.startswith("beit"):
        return ti.map_dpt_beit_key, None
    if backbone.startswith("swin"):
        version = NARROW_SWIN[backbone][0]
        return (functools.partial(ti.map_dpt_swin_key, version=version),
                ti._preprocess_swin_v2 if version == 2 else None)
    return ti.map_dpt_levit_key, None


@pytest.mark.parametrize("name", [n for n in NINE if "next_vit" not in n])
def test_round_trip_through_the_jax_map(name):
    backbone, kw = _spec(name)
    if backbone == "levit_384":  # the map's geometry: the JAX tree at 224x224
        size = (224, 224)
        shapes = jax.eval_shape(lambda: JDPT(backbone=backbone, **kw).init(
            jax.random.key(0), jnp.zeros((1, *size, 3))))
        params, stats = (jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                dict(shapes[c])) for c in ("params",
                                                                           "batch_stats"))
    else:
        _, params, stats, _, japply, size = built(name)
    model = init_weights_(DPTDepthModel(backbone, input_size=size, **kw),
                          torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():  # tables and scales that are not all alike
        for k, p in model.named_parameters():
            if k.endswith(("bias_table", "attention_biases", "logit_scale", "q_bias", "v_bias")):
                p.normal_(0, 0.5, generator=torch.Generator().manual_seed(len(k)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    key_map, preprocess = _jax_map(backbone)
    jparams, jstats, report = ti.import_state_dict(preprocess(sd) if preprocess else sd,
                                                   params, stats, key_map)
    assert not report["shape_mismatch"], report["shape_mismatch"][:5]
    assert sorted(report["unmapped"]) == sorted(k for k in sd if _dead(model, k))
    n_leaves = len(jax.tree_util.tree_leaves(params)) + len(jax.tree_util.tree_leaves(stats))
    live = {k for k in sd if not _dead(model, k)}
    assert report["loaded"] + _fans(live, backbone) == n_leaves  # every JAX leaf, once
    back = state_dict_from_flax(jparams, jstats, "DPTDepthModel")
    assert set(back) == live
    for k in live:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    if backbone != "levit_384":
        x = _x(size, seed=2)
        with torch.no_grad():
            got = model(_nchw(x)).numpy()
        want = np.asarray(japply(jparams, jstats, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _fans(keys, backbone):
    """JAX leaves beyond one a key: BEiT's fused qkv weight fills q, k and v;
    each of a LeViT attention's fused qkv leaves (weight and four BN vectors)
    fills a q and a kv leaf."""
    if backbone.startswith("beit"):
        return 2 * sum(k.endswith(".attn.qkv.weight") for k in keys)
    return sum(".m.qkv." in k for k in keys)


def test_next_vit_has_mde_tpus_names():
    """No reference grammar: its keys are mde_tpu's module paths under
    ``pretrained.model``, and ``state_dict_from_flax`` fills every one."""
    _, params, stats, port, _, _ = built("dpt_next_vit_large_384")
    sd = state_dict_from_flax(params, stats, "DPTDepthModel")
    trunk = {k for k in sd if k.startswith("pretrained.")}
    flat = {"pretrained.model." + ".".join(p[1:]) for p in _paths(params["pretrained"])}
    assert {k.rsplit(".", 1)[0] for k in trunk} == {
        f.replace(".Conv_0", "").replace(".BatchNorm_0", "").rsplit(".", 1)[0] for f in flat}
    assert set(sd) == {k for k in port.state_dict() if not _dead(port, k)}


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _paths(v, prefix + (k,))
        else:
            yield ("pretrained",) + prefix + (k,)


# ---------------------------------------------------------------------------
# One train step a family
# ---------------------------------------------------------------------------

# Next-ViT-L's step compiles JAX's backward for 40 blocks (25 s under the
# tier-1 run's six workers): slow
FAMILIES = ["dpt_beit_base_384", "dpt_swin_large_384", "dpt_swin2_tiny_256", "dpt_levit_224",
            pytest.param("dpt_next_vit_large_384", marks=pytest.mark.slow)]


def _loss_cfg(cfg, size):
    cfg.framework.input_size = cfg.framework.native_size = list(size)
    cfg.framework.compute_dtype = "float32"
    cfg.model.loss_function.grad_loss_alpha = 0.5
    cfg.model.loss_function.edge_loss_alpha = 0.1
    cfg.model.loss_function.silog_loss.alpha = 0.5
    return cfg


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name):
    jm, params, stats, port, _, size = built(name)
    rng = np.random.default_rng(12)
    rgb = rng.uniform(-2.0, 2.0, (2, *size, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, (2, *size)).astype(np.float32)
    jcfg = _loss_cfg(jax_config.defaults(), size)

    def loss_fn(p, s, x, y):
        pred, _ = jm.apply({"params": p, "batch_stats": s}, x, train=True,
                           mutable=["batch_stats"])
        pred = jresize(pred.astype(jnp.float32), y.shape[-2:], align_corners=True)
        return jax_combined_loss(pred, y, jcfg, rgb=x)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params, stats, jnp.asarray(rgb),
                                                           jnp.asarray(depth))
    model = copy.deepcopy(port)
    cfg = _loss_cfg(parse_config("train", argv=[])[0], size)
    with launch.train_pipeline(launch.given_pipeline):  # the inputs are post-pipeline
        step = make_train_step(model, cfg, make_optimizer(model, cfg), plain=True)
    out = step(_nchw(rgb), torch.from_numpy(depth), step_generator(0, 0, 0))
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), rtol=1e-4)
    gj = state_dict_from_flax(jax.device_get(grads_j), None, "DPTDepthModel")
    keys = sorted(gj)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert set(keys) == set(grads) == {k for k, _ in model.named_parameters()
                                       if not _dead(model, k)}
    flat_t = torch.cat([grads[k].double().flatten() for k in keys])
    flat_j = torch.cat([gj[k].double().flatten() for k in keys])
    assert ((flat_j - flat_t).norm() / flat_t.norm()).item() < 0.15

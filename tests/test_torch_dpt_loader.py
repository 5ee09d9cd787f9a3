"""The port's MiDaS model loader and host transforms against the JAX
package's, and LeViT's BatchNorm across processes, on the CPU.

- ``data/midas_transforms.py``: ``compute_resize_shape`` over every method,
  aspect rule and multiple on the cases of tests/test_data.py:146-224 and
  more, and every ``transforms()`` pipeline on a 426x560 frame with its
  depth, disparity and mask planes, equal to mde_tpu's bit for bit;
  ``apply_min_size`` likewise.
- ``models/model_loader.py``: the 14-row table equal to mde_tpu's; each of the
  13 buildable rows built (on the meta device) as the right class with JAX's
  parameter count at full width plus the reference grammar's dead keys, less
  Swin V2's k bias thirds, which timm's grammar does not hold
  (``jax.eval_shape`` of mde_tpu's model at the row's input size); the
  openvino row and an unknown name raise as in mde_tpu; ``device="cuda"``
  raises with no card; a missing checkpoint path prints the note; a real
  build of dpt_levit_224 on the CPU runs on its transform's output, and the
  same seed gives the same weights; LeViT's short map through the eval and
  metric steps, resized to the target.
- ``parallel``: ``convert_sync_batchnorm`` turns every BatchNorm of a LeViT
  and a Next-ViT DPT into the cross-process form, ``LinearBN``'s
  ``BatchNorm1d`` over (B*N, C) tokens included; then two gloo processes
  (``python -m mde_tpu_torch.parallel.launch``) run ``LinearBN`` in training
  mode on halves of a batch, against one process on the whole batch in
  float64 and float32: outputs, input gradients, summed parameter gradients
  and running statistics.
"""

import contextlib
import io
import shutil
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.data import midas_transforms as jmt
from mde_tpu.models import model_loader as jloader
from mde_tpu.utils import count_params as jax_count_params
from mde_tpu_torch.data import midas_transforms as mt
from mde_tpu_torch.models import model_loader
from mde_tpu_torch.models.dpt import DPTDepthModel
from mde_tpu_torch.models.midas_net import MidasNet
from mde_tpu_torch.models.midas_small import MidasNetSmall
from mde_tpu_torch.nn.levit import LinearBN
from mde_tpu_torch.parallel import launch
from mde_tpu_torch.parallel.sync_batchnorm import (SyncBatchNorm, SyncBatchNorm1d,
                                                   convert_sync_batchnorm)
from mde_tpu_torch.utils import count_params

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# Host transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["lower_bound", "upper_bound", "minimal"])
@pytest.mark.parametrize("keep", [False, True])
def test_compute_resize_shape_is_mde_tpus(method, keep):
    for in_w, in_h in ((560, 426), (426, 560), (384, 384), (1000, 37), (33, 65)):
        for tw, th, mult in ((384, 384, 32), (512, 512, 32), (224, 224, 32), (64, 48, 1),
                             (256, 256, 14)):
            assert mt.compute_resize_shape(in_w, in_h, tw, th, keep, mult, method) == \
                jmt.compute_resize_shape(in_w, in_h, tw, th, keep, mult, method)
    with pytest.raises(ValueError, match="not implemented"):
        mt.compute_resize_shape(10, 10, 8, 8, method="nearest")


def _sample(seed=0, size=(426, 560)):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.1, 10.0, size).astype(np.float32)
    return {"image": rng.uniform(0, 1, (*size, 3)).astype(np.float32), "depth": depth,
            "disparity": 1.0 / depth, "mask": depth > 2.0}


@pytest.mark.parametrize("name", sorted(jmt.transforms()))
def test_transform_pipelines_are_mde_tpus_bit_for_bit(name):
    got = mt.transforms()[name](_sample())
    want = jmt.transforms()[name](_sample())
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["image"].shape[2] == 3  # HWC


def test_resize_targets_and_min_size_are_mde_tpus():
    for size in ((100, 120), (30, 20)):
        for r in (dict(resize_method="minimal"), dict(resize_method="lower_bound",
                                                      keep_aspect_ratio=True)):
            got = mt.Resize(64, 64, ensure_multiple_of=32, **r)(_sample(1, size))
            want = jmt.Resize(64, 64, ensure_multiple_of=32, **r)(_sample(1, size))
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        got, want = _sample(2, size), _sample(2, size)
        shape, jshape = mt.apply_min_size(got, (64, 48)), jmt.apply_min_size(want, (64, 48))
        assert (shape is got) == (jshape is want) and (shape is got or shape == jshape)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------

def test_loader_table_is_mde_tpus():
    assert list(model_loader.DEFAULT_MODELS) == list(jloader.DEFAULT_MODELS)
    assert model_loader.DEFAULT_MODELS == jloader.DEFAULT_MODELS
    assert len(model_loader.DEFAULT_MODELS) == 14


def _meta_builds(monkeypatch):
    """load_model's (class, kwargs, module built on the meta device), with no
    weights drawn."""
    seen = []

    def build(cls, kwargs, device, generator):
        with torch.device("meta"):
            seen.append((cls, kwargs, cls(**kwargs)))
        return seen[-1][2]

    monkeypatch.setattr(model_loader, "build_module", build)
    return seen


BUILDABLE = [n for n, row in jloader.DEFAULT_MODELS.items() if row[0] is not None]


@pytest.mark.parametrize("name", BUILDABLE)
def test_load_model_builds_each_row_at_full_width(name, monkeypatch):
    seen = _meta_builds(monkeypatch)
    model, size, transform = model_loader.load_model(name, device="cpu")
    spec, jsize, tname = jloader.DEFAULT_MODELS[name]
    assert size == jsize and transform is not None
    cls, kwargs, _ = seen[0]
    assert cls is (MidasNet if spec == "midas" else MidasNetSmall if spec == "midas_small"
                   else DPTDepthModel)
    jm, _, _ = jloader.load_model(name)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *size, 3))))
    dead = sum(p.numel() for k, p in model.named_parameters()
               if k.startswith(model.DEAD_KEY_PREFIXES))
    # Swin V2: mde_tpu's qkv bias holds a k third that timm's grammar has not
    k_thirds = sum(p.numel() for k, p in model.named_parameters()
                   if k.startswith("pretrained.model.layers.") and k.endswith(".attn.q_bias"))
    assert count_params(model) + k_thirds == jax_count_params(shapes["params"]) + dead


def test_load_model_refusals_and_note(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="openvino"):
        model_loader.load_model("openvino_midas_v21_small_256", device="cpu")
    with pytest.raises(ValueError, match="Unknown model_type"):
        model_loader.load_model("dpt_vit_huge", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model_loader.load_model("dpt_levit_224")  # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model_loader.load_model("dpt_levit_224", device="cuda:0")
    _meta_builds(monkeypatch)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        model_loader.load_model("midas_v21_small_256", str(tmp_path / "none.pt"), device="cpu")
    assert "not found; model is randomly initialized" in printed.getvalue()


def test_load_model_levit_runs_on_its_transform():
    """A real build on the CPU (seed 0 unless a generator is given), run in
    eval mode on its host transform's output of a 426x560 frame."""
    model, size, transform = model_loader.load_model("dpt_levit_224", device="cpu")
    again, _, _ = model_loader.load_model("dpt_levit_224", device="cpu",
                                          generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    img = np.random.default_rng(0).uniform(0, 1, (426, 560, 3)).astype(np.float32)
    x = transform({"image": img})["image"]
    assert x.shape == (*size, 3)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x).permute(2, 0, 1)[None])
    assert out.shape == (1, size[0] - 6, size[1] - 6) and torch.isfinite(out).all()


def test_levit_eval_steps_hold_its_short_map_to_the_target():
    """LeViT's map is 6 pixels short of its input; the eval and metric steps
    resize it to the target (align corners) before the losses and metrics,
    as the train step does (its step against JAX: test_torch_dpt_trunks.py)."""
    from mde_tpu_torch.core import config
    from mde_tpu_torch.data.transforms import preprocess_eval
    from mde_tpu_torch.losses.losses import combined_loss
    from mde_tpu_torch.metrics.metrics import evaluation_metrics
    from mde_tpu_torch.nn.blocks import init_weights_
    from mde_tpu_torch.ops.resize import resize_bilinear
    from mde_tpu_torch.train.trainer import make_eval_step, make_metric_step

    size = (128, 128)
    cfg = config.defaults()
    cfg.framework.input_size = list(size)
    model = init_weights_(DPTDepthModel("levit_384", head_features_1=64, head_features_2=8,
                                        input_size=size), torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.scratch.output_conv[4].bias.add_(0.5)
    rng = np.random.default_rng(0)
    rgb_u8 = torch.from_numpy(rng.integers(0, 256, (2, 60, 80, 3), dtype=np.uint8))
    depth_raw = torch.from_numpy(rng.uniform(0.5, 5.0, (2, 60, 80)).astype(np.float32))
    rgb, depth = preprocess_eval(rgb_u8, depth_raw, input_size=size)
    with torch.no_grad():
        pred = model.eval()(rgb)
    assert pred.shape == (2, 122, 122)
    pred = resize_bilinear(pred, size, align_corners=True)
    want = combined_loss(pred, depth, cfg, rgb=rgb)[0]
    got = make_eval_step(model, cfg)(rgb_u8, depth_raw)["loss"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    metrics = make_metric_step(model, cfg)(rgb_u8, depth_raw)
    want = evaluation_metrics(pred, depth, base_thres=float(cfg.framework.eval_base_thres),
                              n_delta=int(cfg.framework.eval_n_delta))
    assert metrics.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(metrics[k], want[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# LeViT's BatchNorm across processes
# ---------------------------------------------------------------------------

def test_data_parallel_conversion_reaches_every_batchnorm():
    for backbone in ("levit_384", "next_vit_large_6m"):
        with torch.device("meta"):
            model = convert_sync_batchnorm(DPTDepthModel(backbone))
        bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
        assert bns and all(type(m) in (SyncBatchNorm, SyncBatchNorm1d) for m in bns)
        if backbone == "levit_384":
            assert sum(type(m) is SyncBatchNorm1d for m in bns) == 58  # every LinearBN


def _linear_bn_input(dtype):
    g = torch.Generator().manual_seed(0)
    layer = LinearBN(6, 5).to(dtype)
    with torch.no_grad():
        layer.c.weight.uniform_(-0.5, 0.5, generator=g)
        layer.bn.weight.uniform_(0.5, 1.5, generator=g)
        layer.bn.bias.uniform_(-0.5, 0.5, generator=g)
        layer.bn.running_mean.uniform_(-0.5, 0.5, generator=g)
        layer.bn.running_var.uniform_(0.5, 1.5, generator=g)
    return {"x": (torch.randn(4, 9, 6, generator=g) * 2 + 0.5).to(dtype),
            "dy": torch.randn(4, 9, 5, generator=g).to(dtype), "state_dict": layer.state_dict()}


# (atol of the output, input gradient and running statistics; atol of the
# summed parameter gradients): float32 sums of 36 tokens
LINEAR_BN_TOL = {"float64": (1e-12, 1e-12), "float32": (1e-6, 2e-5)}


@pytest.fixture(scope="module")
def linear_bn_ranks():
    root = Path(tempfile.mkdtemp(prefix="linear_bn_"))
    jobs = []
    for dtype in LINEAR_BN_TOL:
        torch.save(_linear_bn_input(getattr(torch, dtype)), root / f"{dtype}.pt")
        jobs.append({"name": dtype, "mode": "batchnorm", "layer": "linear_bn",
                     "input": str(root / f"{dtype}.pt")})
    spec = {"world": 2, "device": "cpu", "out": str(root), "threads": 1, "jobs": jobs}
    yield launch.run(spec, str(root / "spec.json"), timeout=300)
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("dtype", sorted(LINEAR_BN_TOL))
def test_linear_bn_across_two_processes_matches_one(linear_bn_ranks, dtype):
    atol, atol_sums = LINEAR_BN_TOL[dtype]
    data = _linear_bn_input(getattr(torch, dtype))
    layer = LinearBN(6, 5).to(getattr(torch, dtype))
    layer.load_state_dict(data["state_dict"])
    x = data["x"].clone().requires_grad_(True)
    y = layer.train()(x)
    y.backward(data["dy"])
    ranks = linear_bn_ranks[dtype]
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    np.testing.assert_allclose(torch.cat([r["y"] for r in ranks]).numpy(), y.detach().numpy(),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(torch.cat([r["dx"] for r in ranks]).numpy(), x.grad.numpy(),
                               atol=atol, rtol=0)
    for k, p in layer.named_parameters():
        np.testing.assert_allclose(sum(r["grads"][k] for r in ranks).numpy(), p.grad.numpy(),
                                   atol=atol_sums, rtol=0, err_msg=k)
    for r in ranks:
        for k, v in layer.state_dict().items():
            np.testing.assert_allclose(r["state_dict"][k].numpy(), v.numpy(), atol=atol, rtol=0,
                                       err_msg=k)

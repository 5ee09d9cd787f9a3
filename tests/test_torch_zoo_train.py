"""The model factory's every branch, and the training and serving paths of
two new models, in the port against the JAX package's, at float32 on the CPU.

- The factory builds each ``model_type`` and ``use_lb``/``use_dgr``
  combination of mde_tpu/models/factory.py:39-66 (the DPT_Large ViT narrowed
  in both packages, as in tests/test_torch_zoo_models.py) as the right class,
  with JAX's parameter count plus the reference grammar's dead keys, the
  same weights from the same seed; the other DPT backbones raise naming
  ROADMAP item 6.6.
- One step-synced train step against JAX for MiDaS-small + LocalBins + DGR
  and for U-Net (64x96, B=2, every loss term on), their weights from
  tests/test_torch_zoo_models.py's cases, the same post-pipeline inputs on
  both sides, JAX's loss and gradients from ``jax.value_and_grad`` of its
  ``combined_loss``, as its train step takes them. Loss at rtol 1e-4;
  gradients at 0.15 global and 0.3 per top-level module rel-L2 (the noise
  band of tests/test_train_parity.py:444-457).
- ``build_service`` from each of those models' ``--set``s: a reply equals
  the predict step.
"""

import copy
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.data import transforms as JT
from mde_tpu.losses import combined_loss as jax_combined_loss
from mde_tpu.models import factory as jfactory
from mde_tpu.utils import count_params as jax_count_params
from mde_tpu_torch.core import config
from mde_tpu_torch.models import factory
from mde_tpu_torch.models.dpt import DPTDepthModel
from mde_tpu_torch.models.midas_net import MidasNet
from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
from mde_tpu_torch.models.midas_small import MidasNetSmall
from mde_tpu_torch.models.simple_unet import SimpleUNet
from mde_tpu_torch.tools.common import parse_config
from mde_tpu_torch.tools.serve import build_service
from mde_tpu_torch.train.checkpoint import checkpoint_path, save_checkpoint
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.train.trainer import forward_backward, make_predict_step
from mde_tpu_torch.utils import count_params
from tests.test_torch_modules import _nchw
from tests.test_torch_zoo_models import CASES, SIZE, _dead, built, narrow_vitl  # noqa: F401

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# The factory
# ---------------------------------------------------------------------------

FACTORY = {
    # model_type, dinov2_type, use_lb, use_dgr -> port class
    ("MiDaS_small", None, False, False): MidasNetSmall,
    ("MiDaS_small", None, True, False): MidasNetSmall,
    ("MiDaS_small", None, False, True): MidasNetSmall,
    ("MiDaS_small", None, True, True): MidasNetSmall,
    ("MiDaS_small", "dinov2_vits14", True, False): MidasNetSemantics,
    ("MiDaS_small", "dinov2_vits14", False, True): MidasNetSemantics,
    ("MiDaS_small", "dinov2_vits14", True, True): MidasNetSemantics,
    ("U_Net", None, False, False): SimpleUNet,
    ("MiDaS", None, False, False): MidasNet,
    ("DPT_Large", None, False, False): DPTDepthModel,
    ("DPT_Hybrid", None, False, False): DPTDepthModel,
}


def _model_cfg(module, model_type, dinov2_type, use_lb, use_dgr):
    cfg = module.defaults()
    cfg.model.model_type = model_type
    cfg.model.dinov2_type = dinov2_type
    cfg.model.network.use_lb, cfg.model.network.use_dgr = use_lb, use_dgr
    return cfg


@pytest.mark.parametrize("key", list(FACTORY), ids=lambda k: "-".join(map(str, k)))
def test_factory_builds_every_branch(key):
    """The branch's class, with the JAX module's parameters plus the reference
    grammar's dead ones, drawn from the generator (the same seed, the same
    weights); ``use_dgr`` on the flagship builds dead blocks."""
    cfg = _model_cfg(config, *key)
    model = factory.build_model(cfg.model, "cpu", torch.Generator().manual_seed(0))
    assert type(model) is FACTORY[key]
    jm = jfactory.build_model(_model_cfg(jax_config, *key).model)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *SIZE, 3))))
    n_dead = sum(p.numel() for k, p in model.named_parameters() if _dead(model, k))
    assert count_params(model) == jax_count_params(shapes["params"]) + n_dead
    assert all(torch.isfinite(v).all() for v in model.state_dict().values())
    if key[3] and key[1] is not None:
        assert n_dead > 0 and all(k.startswith(model.DEAD_KEY_PREFIXES)
                                  for k in model.state_dict() if k.startswith("dgr"))
    again = factory.build_model(cfg.model, "cpu", torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_factory_refuses_other_backbones():
    with pytest.raises(NotImplementedError, match="6.6"):
        DPTDepthModel("beitl16_384")
    cfg = config.defaults()
    cfg.model.model_type = "MiDaS_large"
    with pytest.raises(ValueError, match="Unknown model_type"):
        factory.build_model(cfg.model, "cpu", torch.Generator())


# ---------------------------------------------------------------------------
# Training and serving
# ---------------------------------------------------------------------------

TRAIN_SETS = {"midas_small_lb_dgr": ("model.dinov2_type=null", "model.network.use_lb=true",
                                     "model.network.use_dgr=true"),
              "unet": ("model.model_type=U_Net",)}


def _argv(name, *extra):
    return [a for item in TRAIN_SETS[name] + extra for a in ("--set", item)]


def _loss_cfg(cfg):
    """Small inputs, float32, and every loss term on."""
    cfg.framework.input_size = cfg.framework.native_size = list(SIZE)
    cfg.framework.compute_dtype = "float32"
    cfg.model.loss_function.grad_loss_alpha = 0.5
    cfg.model.loss_function.edge_loss_alpha = 0.1
    cfg.model.loss_function.silog_loss.alpha = 0.5
    return cfg


@pytest.mark.parametrize("name", sorted(TRAIN_SETS))
def test_train_step_matches_jax_step_synced(name):
    jm, params, stats, port, _ = built(name)
    rng = np.random.default_rng(12)
    u8 = rng.integers(0, 255, (2, *SIZE, 3)).astype(np.uint8)
    depth = rng.uniform(0.5, 5.0, (2, *SIZE)).astype(np.float32)
    rgb, depth = (np.asarray(a) for a in JT.make_train_pipeline(False, SIZE)(
        jax.random.key(123), jnp.asarray(u8), jnp.asarray(depth)))
    cfg = _loss_cfg(parse_config("train", argv=_argv(name))[0])
    jcfg = _loss_cfg(jax_config.defaults())
    assert factory._model_class(cfg.model)[0] is type(port)

    def loss_fn(p, s, x, y):
        pred, _ = jm.apply({"params": p, "batch_stats": s}, x, train=True,
                           mutable=["batch_stats"])
        return jax_combined_loss(pred.astype(jnp.float32), y, jcfg, rgb=x)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params, stats, jnp.asarray(rgb),
                                                           jnp.asarray(depth))
    model = copy.deepcopy(port)
    loss_t, _ = forward_backward(model, cfg, _nchw(rgb), torch.from_numpy(depth.copy()))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)

    gj = {k: v.double() for k, v in
          state_dict_from_flax(jax.device_get(grads_j), None, CASES[name][2]).items()}
    named = dict(model.named_parameters())
    keys = sorted(gj)
    assert all(named[k].grad is not None for k in keys)
    assert {k for k, p in named.items() if p.grad is not None} == set(keys)
    gt = {k: named[k].grad.double() for k in keys}
    flat_t = torch.cat([gt[k].flatten() for k in keys])
    flat_j = torch.cat([gj[k].flatten() for k in keys])
    gnorm = flat_t.norm().item()
    rel = ((flat_j - flat_t).norm() / gnorm).item()
    assert rel < 0.15, f"global gradient rel-L2 {rel:.3e}"
    for top in sorted({k.split(".", 1)[0] for k in keys}):
        ks = [k for k in keys if k.split(".", 1)[0] == top]
        dv = torch.cat([(gj[k] - gt[k]).flatten() for k in ks])
        tv = torch.cat([gt[k].flatten() for k in ks])
        sub = (dv.norm() / max(tv.norm().item(), 1e-2 * gnorm)).item()
        assert sub < 0.3, f"subtree {top} gradient rel-L2 {sub:.3e}"


@pytest.mark.parametrize("name", sorted(TRAIN_SETS))
def test_build_service_from_the_sets(name, tmp_path):
    """The model's ``--set``s alone select it for the server; a reply equals
    the predict step."""
    port = built(name)[3]
    cfg, _ = parse_config("serve", argv=["--device", "cpu"] + _argv(
        name, f"framework.input_size=[{SIZE[0]},{SIZE[1]}]", f"paths.results_dir={tmp_path}"))
    save_checkpoint(checkpoint_path(str(tmp_path), cfg.experiment.model_name), port)
    service = build_service(cfg, "cpu", max_batch=2, window_ms=1.0, warmup=False)
    try:
        assert type(service.model) is type(port)
        img = np.random.default_rng(3).integers(0, 256, (426, 560, 3), dtype=np.uint8)
        buf = io.BytesIO()
        np.save(buf, img)
        body, _ = service.predict_bytes(buf.getvalue())
        depth = np.load(io.BytesIO(body))
        assert depth.shape == (426, 560) and np.isfinite(depth).all()
        want = make_predict_step(port.eval(), cfg)(torch.from_numpy(img[None])).numpy()[0]
        np.testing.assert_array_equal(depth, want)
    finally:
        service.close()

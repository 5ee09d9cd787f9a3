"""The port's Depth-Anything-V2 training step and server, on the CPU at float32.

- One step-synced DA-V2-S train step (full width at 56x84, B=2, every loss
  term on): the JAX weights (gammas in [0.2, 0.8], final bias raised by 0.5,
  see tests/test_torch_da2.py) carried by ``state_dict_from_flax``, the same
  post-pipeline inputs on both sides, JAX's loss and gradients from
  ``jax.value_and_grad`` of its ``combined_loss``, as its train step takes
  them. Loss at rtol 1e-4; gradients at 0.15 global and 0.3 per top-level
  module rel-L2 (the noise band of tests/test_train_parity.py:444-457). The
  gaps measured are 1.2e-6 (loss) and 5e-5 (global gradient). The trunk
  trains: DA-V2 has no frozen subtree.
- ``build_service`` started by the two ``--set`` overrides that select DA-V2
  (model type and input size), from a checkpoint in the release grammar:
  a request's reply equals the predict step, and a checkpoint without a live
  weight is refused.
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
from mde_tpu_torch.core import config
from mde_tpu_torch.models.depth_anything import DepthAnythingV2
from mde_tpu_torch.tools.common import parse_config
from mde_tpu_torch.tools.serve import build_service
from mde_tpu_torch.train.checkpoint import checkpoint_path, load_state_dict, save_checkpoint
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.train.trainer import (forward_backward, make_predict_step,
                                         trainable_parameters)
from tests.test_torch_da2 import _nchw, da2_params

torch.set_num_threads(2)

SIZE = (56, 84)  # 4x6 tokens


@pytest.fixture(scope="module")
def da2():
    jm, params = da2_params(SIZE, seed=1)
    port = DepthAnythingV2("vits")
    load_state_dict(port, state_dict_from_flax(params, {}, "DepthAnythingV2"))
    return jm, params, port


def _cfg(module):
    cfg = module.defaults()
    cfg.model.model_type = "DepthAnythingV2_vits"
    cfg.framework.input_size = list(SIZE)
    cfg.framework.native_size = list(SIZE)
    cfg.framework.compute_dtype = "float32"
    return cfg


def test_train_step_matches_jax_step_synced(da2):
    jm, params, port = da2
    rng = np.random.default_rng(12)
    u8 = rng.integers(0, 255, (2, *SIZE, 3)).astype(np.uint8)
    depth = rng.uniform(0.5, 5.0, (2, *SIZE)).astype(np.float32)
    rgb, depth = (np.asarray(a) for a in JT.make_train_pipeline(False, SIZE)(
        jax.random.key(123), jnp.asarray(u8), jnp.asarray(depth)))
    cfg, jcfg = _cfg(config), _cfg(jax_config)

    def loss_fn(p, x, y):
        pred = jm.apply({"params": p}, x, train=True)
        return jax_combined_loss(pred.astype(jnp.float32), y, jcfg, rgb=x)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params, jnp.asarray(rgb),
                                                           jnp.asarray(depth))
    model = copy.deepcopy(port)
    loss_t, _ = forward_backward(model, cfg, _nchw(rgb), torch.from_numpy(depth.copy()))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)

    gj = {k: v.double() for k, v in
          state_dict_from_flax(jax.device_get(grads_j), None, "DepthAnythingV2").items()}
    named = dict(model.named_parameters())
    assert [p for p in trainable_parameters(model)] == [named[k] for k in named]
    keys = sorted(gj)
    assert {k.split(".", 1)[0] for k in keys} == {"pretrained", "depth_head"}
    assert all(named[k].grad is not None for k in keys)
    gt = {k: named[k].grad.double() for k in keys}
    flat_t = torch.cat([gt[k].flatten() for k in keys])
    flat_j = torch.cat([gj[k].flatten() for k in keys])
    gnorm = flat_t.norm().item()
    rel = ((flat_j - flat_t).norm() / gnorm).item()
    assert rel < 0.15, f"global gradient rel-L2 {rel:.3e}"
    for top in ("pretrained", "depth_head"):
        ks = [k for k in keys if k.startswith(top + ".")]
        dv = torch.cat([(gj[k] - gt[k]).flatten() for k in ks])
        tv = torch.cat([gt[k].flatten() for k in ks])
        sub = (dv.norm() / max(tv.norm().item(), 1e-2 * gnorm)).item()
        assert sub < 0.3, f"subtree {top} gradient rel-L2 {sub:.3e}"


def _npy(img) -> bytes:
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def test_build_service_from_the_da2_sets(da2, tmp_path):
    """The server needs no flag of its own for DA-V2: the model type and the
    input size select it; requests and replies stay at the native 426x560."""
    port = da2[2]
    cfg, _ = parse_config("serve", argv=[
        "--device", "cpu", "--set", "model.model_type=DepthAnythingV2_vits",
        "--set", f"framework.input_size=[{SIZE[0]},{SIZE[1]}]",
        "--set", f"paths.results_dir={tmp_path}"])
    ckpt = checkpoint_path(str(tmp_path), cfg.experiment.model_name)
    save_checkpoint(ckpt, port)
    service = build_service(cfg, "cpu", max_batch=2, window_ms=1.0, warmup=False)
    try:
        assert isinstance(service.model, DepthAnythingV2) and service.native == (426, 560)
        img = np.random.default_rng(3).integers(0, 256, (426, 560, 3), dtype=np.uint8)
        body, coalesced = service.predict_bytes(_npy(img))
        depth = np.load(io.BytesIO(body))
        assert depth.shape == (426, 560) and depth.dtype == np.float32 and coalesced == 1
        want = make_predict_step(port.eval(), cfg)(torch.from_numpy(img[None])).numpy()[0]
        np.testing.assert_array_equal(depth, want)
        assert (depth > 0).all() and np.isfinite(depth).all()
    finally:
        service.close()

    sd = {k: v for k, v in port.state_dict().items()
          if not k.startswith("depth_head.scratch.output_conv2.2.")}
    torch.save(sd, ckpt)
    with pytest.raises(ValueError, match="unset"):
        build_service(cfg, "cpu", max_batch=1, warmup=False)

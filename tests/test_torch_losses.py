"""The port's losses, metrics and the K2 plain version against the JAX package.

Every function takes the same numpy inputs on both sides (B=2 at 16x24,
positive depths; the masked functions also get target zeros and, for
``masked_si_rmse``, an image with no valid pixel). RGB goes to the port as
NCHW and to JAX as NHWC.

Tolerance: rtol 1e-5 (atol 1e-6 where a value can be near 0) for losses and
metrics, float32 sums in another order on both sides. Gradients of the SI
loss: rtol 1e-5, atol 1e-9; the gradient scale here is ~1e-4 a pixel (1/n
with n = 2745), so float32 rounding stays near 1e-11. The bare sums' backward
with O(1) cotangents: atol 1e-6, where g1 + 2 d g2 cancels to near 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.losses import losses as JL
from mde_tpu.metrics import metrics as JM
from mde_tpu.ops.pallas_kernels import scale_invariant_loss_fused, si_loss_sums as jax_si_sums
from mde_tpu_torch.core import config
from mde_tpu_torch.losses import losses as L
from mde_tpu_torch.metrics import metrics as M
from mde_tpu_torch.ops import kernels as K

torch.set_num_threads(2)
RTOL = 1e-5


def _inputs(seed=0, shape=(2, 16, 24), zeros=False):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0.5, 10.0, shape).astype(np.float32)
    pred = (target * np.exp(rng.normal(0.2, 0.3, shape))).astype(np.float32)
    if zeros:
        target[rng.random(shape) < 0.2] = 0.0
    rgb = rng.random(shape + (3,), dtype=np.float32)
    return pred, target, rgb


def _cfg():
    cfg = config.defaults()
    lf = cfg.model.loss_function
    lf.si_loss_alpha, lf.silog_loss.alpha, lf.grad_loss_alpha, lf.edge_loss_alpha = 1.0, 0.3, 0.2, 0.1
    return cfg


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nchw(rgb):
    return _t(rgb.transpose(0, 3, 1, 2))


CASES = {
    "scale_invariant": (False, lambda p, t, r: L.scale_invariant_loss(_t(p), _t(t)),
                        lambda p, t, r: JL.scale_invariant_loss(p, t)),
    "scale_invariant_sqroot": (False, lambda p, t, r: L.scale_invariant_loss(_t(p), _t(t), sqroot=True),
                               lambda p, t, r: JL.scale_invariant_loss(p, t, sqroot=True)),
    "silog": (True, lambda p, t, r: L.silog_loss(_t(p), _t(t), variance_focus=0.85),
              lambda p, t, r: JL.silog_loss(p, t, variance_focus=0.85)),
    "gradient": (False, lambda p, t, r: L.gradient_loss(_t(p), _t(t)),
                 lambda p, t, r: JL.gradient_loss(p, t)),
    "edge_aware": (False, lambda p, t, r: L.edge_aware_loss(_t(p), _t(t), _nchw(r), beta=0.7),
                   lambda p, t, r: JL.edge_aware_loss(p, t, r, beta=0.7)),
    "per_pixel_si": (False, lambda p, t, r: L.per_pixel_scale_invariant_loss(_t(p[0]), _t(t[0])),
                     lambda p, t, r: JL.per_pixel_scale_invariant_loss(p[0], t[0])),
    "delta_thres": (False, lambda p, t, r: M.delta_thres(_t(p), _t(t), 1.25),
                    lambda p, t, r: JM.delta_thres(p, t, 1.25)),
    "abs_rel": (True, lambda p, t, r: M.absolute_relative_error(_t(p), _t(t)),
                lambda p, t, r: JM.absolute_relative_error(p, t)),
    "masked_si_rmse": (True, lambda p, t, r: M.masked_si_rmse(_t(p), _t(t)),
                       lambda p, t, r: JM.masked_si_rmse(p, t)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_or_metric_matches_jax(name):
    zeros, port, ref = CASES[name]
    pred, target, rgb = _inputs(zeros=zeros)
    got = port(pred, target, rgb).numpy()
    want = np.asarray(ref(*map(jnp.asarray, (pred, target, rgb))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_masked_si_rmse_skips_an_image_without_valid_pixels():
    pred, target, _ = _inputs(zeros=True)
    target[1] = 0.0
    got = M.masked_si_rmse(_t(pred), _t(target)).item()
    want = float(JM.masked_si_rmse(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, M.masked_si_rmse(_t(pred[:1]), _t(target[:1])).item(), rtol=RTOL)


def test_combined_loss_matches_jax_with_every_term_on():
    pred, target, rgb = _inputs(zeros=True)
    cfg = _cfg()
    total, parts = L.combined_loss(_t(pred), _t(target), cfg, rgb=_nchw(rgb))
    jtotal, jparts = JL.combined_loss(jnp.asarray(pred), jnp.asarray(target), cfg,
                                      rgb=jnp.asarray(rgb))
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=RTOL)
    assert set(parts) == set(jparts)
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=RTOL, err_msg=k)


def test_combined_loss_returns_every_part_at_the_default_alphas():
    """The default config weights the SI term alone; the other parts are
    still computed (and logged), as 0."""
    pred, target, rgb = _inputs()
    total, parts = L.combined_loss(_t(pred), _t(target), config.defaults(), rgb=_nchw(rgb))
    assert set(parts) == {"si_loss", "silog_loss", "grad_loss", "edge_loss"}
    assert parts["silog_loss"].item() == parts["grad_loss"].item() == parts["edge_loss"].item() == 0
    assert total.item() == parts["si_loss"].item() > 0


def test_evaluation_and_full_suite_match_jax():
    pred, target, _ = _inputs(zeros=True)
    target = np.maximum(target, 0.05)  # the eval protocol divides by target
    got = M.evaluation_metrics(_t(pred), _t(target), base_thres=1.05, n_delta=3)
    want = JM.evaluation_metrics(jnp.asarray(pred), jnp.asarray(target), 1.05, 3)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, err_msg=k)
    got = M.full_metric_suite(_t(pred), _t(target))
    want = JM.full_metric_suite(jnp.asarray(pred), jnp.asarray(target))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("shape", [(2, 16, 24), (3, 45, 61)])
def test_si_loss_sums_plain_matches_pallas_and_the_loss(shape):
    """The plain version against the Pallas kernel (interpret mode on the
    CPU) and the fused loss against ``scale_invariant_loss``; 45x61 = 2745 is
    not a multiple of the 2048-element chunk, so the tail is masked."""
    pred, target, _ = _inputs(seed=1, shape=shape)
    s1, s2 = K.si_loss_sums_plain(_t(pred), _t(target))
    j1, j2 = jax_si_sums(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(s1.numpy(), np.asarray(j1), rtol=RTOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(j2), rtol=RTOL)
    for sqroot in (False, True):
        got = L.scale_invariant_loss(_t(pred), _t(target), sqroot=sqroot).item()
        want = float(JL.scale_invariant_loss(jnp.asarray(pred), jnp.asarray(target), sqroot=sqroot))
        fused = float(scale_invariant_loss_fused(jnp.asarray(pred), jnp.asarray(target), sqroot=sqroot))
        np.testing.assert_allclose(got, want, rtol=RTOL)
        np.testing.assert_allclose(got, fused, rtol=RTOL)


def test_si_loss_gradient_matches_jax_grad_and_the_custom_vjp():
    """d loss / d pred through the autograd Function (the K2 backward's plain
    version on the CPU) against ``jax.grad`` of ``scale_invariant_loss`` and
    of the Pallas custom VJP; dtarget against the VJP's when asked for."""
    pred, target, _ = _inputs(seed=2, shape=(3, 45, 61))
    tp, tt = _t(pred).requires_grad_(), _t(target).requires_grad_()
    L.scale_invariant_loss(tp, tt).backward()
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    want = jax.grad(JL.scale_invariant_loss)(jp, jt)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want), rtol=RTOL, atol=1e-9)
    vjp_p, vjp_t = jax.grad(scale_invariant_loss_fused, argnums=(0, 1))(jp, jt)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(vjp_p), rtol=RTOL, atol=1e-9)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(vjp_t), rtol=RTOL, atol=1e-9)


def test_si_loss_sums_backward_skips_the_target_gradient():
    """The depth target needs no gradient, so the backward computes none;
    the cotangents of both sums reach pred as in ``_si_sums_bwd``."""
    pred, target, _ = _inputs(seed=3)
    tp = _t(pred).requires_grad_()
    s1, s2 = K.si_loss_sums(tp, _t(target))
    g1, g2 = np.array([0.3, -1.2], np.float32), np.array([0.7, 0.05], np.float32)
    ((s1 * _t(g1)).sum() + (s2 * _t(g2)).sum()).backward()
    _, vjp = jax.vjp(lambda p: jax_si_sums(p, jnp.asarray(target)), jnp.asarray(pred))
    (want,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    dpred, dtarget = K.si_loss_sums_backward_plain(_t(pred), _t(target), _t(g1), _t(g2), 1e-6, False)
    assert dtarget is None
    np.testing.assert_allclose(dpred.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)

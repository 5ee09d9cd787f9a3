"""The port's training path against the JAX package's, on the CPU at float32.

- Colour jitter and ``preprocess_train``: the JAX package's draws (made with
  the ``jax.random`` calls of mde_tpu/ops/image.py:143-150) are injected into
  ``color_jitter_apply``. rtol 1e-5; hue, and the jitter that includes it, at
  atol 2e-6, the bound of the JAX package's own hue test.
- ``make_optimizer`` against mde_tpu's on a tree with a frozen ``dinov2``
  subtree, fed identical gradients: updated parameters at rtol 1e-6, atol
  1e-7, and ``dinov2`` bit-identical.
- One step-synced flagship step (64x96, DINOv2 at 28x42, B=2, every loss term
  on), weights carried by ``state_dict_from_flax``, the same post-pipeline
  inputs on both sides: loss at rtol 1e-4. The init is seed 1: at seed 0 one
  pixel of the prediction sits at 1e-3, near the ReLU floor, where the log of
  the SI loss turns the frameworks' ordinary 1e-4 absolute difference in depth
  into a 0.125 difference in log depth and the loss differs by 1.4e-4; seeds 1
  and 3 agree to 2e-6. Gradients at 0.15 global and 0.3 per top-level module
  rel-L2, the flagship's noise band (tests/test_train_parity.py:444-457); BN running
  statistics at rtol 1e-3, atol 1e-5 after the step, with torch's unbiased
  variance mapped from flax's biased one by n/(n-1) (n = B*H*W at the layer).
- ``accum_steps=2`` against the same two microbatches done by hand: equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.data import transforms as JT
from mde_tpu.losses import combined_loss as jax_combined_loss
from mde_tpu.models import MidasNetSemantics as JMidasNetSemantics
from mde_tpu.ops import image as JI
from mde_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mde_tpu_torch.core import config
from mde_tpu_torch.data import transforms as T
from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
from mde_tpu_torch.ops import image as I
from mde_tpu_torch.train.checkpoint import load_state_dict
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.train.trainer import (forward_backward, make_optimizer, make_train_step,
                                         step_generator, trainable_parameters)
from tests.test_torch_modules import _randomize

torch.set_num_threads(2)

DINO = (28, 42)
SIZE = (64, 96)
SEED = 1  # the flagship's init; see the module docstring
ALPHAS = {"si": 1.0, "silog": 0.3, "vf": 0.85, "grad": 0.2, "edge": 0.1}


def _cfg(module):
    cfg = module.defaults()
    cfg.framework.input_size = list(SIZE)
    cfg.framework.native_size = list(SIZE)
    cfg.framework.compute_dtype = "float32"
    lf = cfg.model.loss_function
    lf.si_loss_alpha, lf.silog_loss.alpha = ALPHAS["si"], ALPHAS["silog"]
    lf.silog_loss.variance_focus = ALPHAS["vf"]
    lf.grad_loss_alpha, lf.edge_loss_alpha = ALPHAS["grad"], ALPHAS["edge"]
    return cfg


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _jax_draws(key, b, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1):
    """The draws of mde_tpu/ops/image.py::color_jitter, made the same way."""
    k_b, k_c, k_s, k_h, k_perm = jax.random.split(key, 5)
    fb = jax.random.uniform(k_b, (b,), minval=max(0.0, 1 - brightness), maxval=1 + brightness)
    fc = jax.random.uniform(k_c, (b,), minval=max(0.0, 1 - contrast), maxval=1 + contrast)
    fs = jax.random.uniform(k_s, (b,), minval=max(0.0, 1 - saturation), maxval=1 + saturation)
    fh = jax.random.uniform(k_h, (b,), minval=-hue, maxval=hue)
    perms = jax.vmap(lambda k: jax.random.permutation(k, 4))(jax.random.split(k_perm, b))
    return [torch.from_numpy(np.asarray(x).copy()) for x in (fb, fc, fs, fh, perms)]


# ---------------------------------------------------------------------------
# Colour jitter and the train pipeline
# ---------------------------------------------------------------------------

ADJUST = {
    "brightness": (I.adjust_brightness, JI.adjust_brightness, (0.8, 1.2), 0.0),
    "contrast": (I.adjust_contrast, JI.adjust_contrast, (0.8, 1.2), 0.0),
    "saturation": (I.adjust_saturation, JI.adjust_saturation, (0.8, 1.2), 0.0),
    "hue": (I.adjust_hue, JI.adjust_hue, (-0.1, 0.1), 2e-6),
}


@pytest.mark.parametrize("name", sorted(ADJUST))
def test_adjustment_matches_jax(name):
    port, ref, (lo, hi), atol = ADJUST[name]
    rng = np.random.default_rng(0)
    x = rng.random((3, 12, 16, 3), dtype=np.float32)
    x[0, :2] = [1.0, 0.0, 0.0]  # saturated and grey pixels take the edge branches
    x[1, :2] = 0.5
    factors = np.array([lo, (lo + hi) / 2, hi], np.float32)
    got = port(_nchw(x), torch.from_numpy(factors)).numpy().transpose(0, 2, 3, 1)
    want = np.stack([np.asarray(ref(jnp.asarray(x[i]), factors[i])) for i in range(3)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def test_color_jitter_apply_matches_jax_color_jitter():
    """Four keys x 6 samples: every adjustment in several orders."""
    rng = np.random.default_rng(1)
    orders = set()
    for seed in range(4):
        x = rng.random((6, 10, 14, 3), dtype=np.float32)
        key = jax.random.key(seed)
        draws = _jax_draws(key, 6)
        orders.update(tuple(p) for p in draws[-1].tolist())
        got = I.color_jitter_apply(_nchw(x), *draws).numpy().transpose(0, 2, 3, 1)
        want = np.asarray(JI.color_jitter(key, jnp.asarray(x), 0.2, 0.2, 0.2, 0.1))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    assert len(orders) >= 10, orders


def test_color_jitter_draws_from_the_generator():
    """Same generator seed, same output; factors inside torchvision's ranges."""
    x = torch.rand(5, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    a = I.color_jitter(x, generator=torch.Generator().manual_seed(3))
    b = I.color_jitter(x, generator=torch.Generator().manual_seed(3))
    c = I.color_jitter(x, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= 1


def test_preprocess_train_matches_jax_with_injected_draws(monkeypatch):
    """Resize (half-pixel, JAX rounding), jitter, normalise, depth resize."""
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (3, 30, 40, 3), dtype=np.uint8)
    depth = rng.uniform(0.5, 10.0, (3, 30, 40)).astype(np.float32)
    key = jax.random.key(7)
    draws = _jax_draws(key, 3)
    monkeypatch.setattr(T, "color_jitter",
                        lambda x, *a, **k: I.color_jitter_apply(x, *draws))
    rgb, d = T.preprocess_train(torch.from_numpy(u8), torch.from_numpy(depth), (32, 48))
    jrgb, jd = JT.preprocess_train(key, jnp.asarray(u8), jnp.asarray(depth), input_size=(32, 48))
    assert rgb.shape == (3, 3, 32, 48) and d.shape == (3, 32, 48)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


class _Tree(torch.nn.Module):
    def __init__(self, leaves):
        super().__init__()
        for top, w in leaves.items():
            sub = torch.nn.Module()
            sub.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
            setattr(self, top, sub)


def test_make_optimizer_matches_jax_and_freezes_dinov2():
    """The top-level key decides: ``dinov2`` is frozen even with
    ``requires_grad`` set, ``dinov2_head`` trains; weight decay must not
    touch the frozen leaf."""
    rng = np.random.default_rng(3)
    tree = {k: (rng.standard_normal(s) * 2).astype(np.float32)
            for k, s in (("dinov2", (6, 4)), ("dinov2_head", (4, 3)), ("head", (5,)))}
    cfg = _cfg(config)
    tx = jax_make_optimizer(_cfg(jax_config), {k: {"w": v} for k, v in tree.items()})
    params = {k: {"w": jnp.asarray(v)} for k, v in tree.items()}
    state = tx.init(params)
    module = _Tree(tree)
    opt = make_optimizer(module, cfg)
    assert [id(p) for p in trainable_parameters(module)] == \
        [id(module.dinov2_head.w), id(module.head.w)]
    for _ in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tree.items()}
        updates, state = tx.update({k: {"w": jnp.asarray(g)} for k, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        for k, g in grads.items():
            getattr(module, k).w.grad = torch.from_numpy(g)
        opt.step()
    for k in tree:
        np.testing.assert_allclose(getattr(module, k).w.detach().numpy(),
                                   np.asarray(params[k]["w"]), rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(module.dinov2.w.detach().numpy(), tree["dinov2"])


# ---------------------------------------------------------------------------
# The flagship train step, step-synced against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    jm = JMidasNetSemantics(dinov2_image_size=DINO)
    variables = jax.jit(lambda k: jm.init(k, jnp.zeros((1, *SIZE, 3)), train=False))(
        jax.random.key(SEED))
    rng = np.random.default_rng(SEED)
    params = _randomize(variables["params"], rng)
    stats = _randomize(variables["batch_stats"], rng)
    # The ReLU-cliff shift of tests/test_train_parity.py: start the depth head
    # positive, so the comparison tests the smooth part of the loss surface.
    params["depth_head_1"]["Conv_0"]["bias"] += 2.0
    port = MidasNetSemantics(dinov2_image_size=DINO)
    load_state_dict(port, state_dict_from_flax(params, stats))
    return jm, params, stats, port


@pytest.fixture(scope="module")
def batch():
    """Post-pipeline inputs from the JAX train pipeline, as test_train_parity feeds JAX."""
    rng = np.random.default_rng(11 + SEED)
    u8 = rng.integers(0, 255, (2, *SIZE, 3)).astype(np.uint8)
    depth = rng.uniform(0.5, 5.0, (2, *SIZE)).astype(np.float32)
    rgb, d = JT.make_train_pipeline(False, SIZE)(jax.random.key(123), jnp.asarray(u8),
                                                   jnp.asarray(depth))
    return np.asarray(rgb), np.asarray(d), u8, depth


def _bn_inputs(model):
    """Record the element count per channel (B*H*W) each BN layer sees."""
    counts, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, name=name: counts.__setitem__(name, args[0].numel() // args[0].shape[1])))
    return counts, hooks


def test_train_step_matches_jax_step_synced(flagship, batch):
    jm, params, stats, port = flagship
    rgb, depth = batch[:2]
    cfg, jcfg = _cfg(config), _cfg(jax_config)

    def loss_fn(p, s, x, y):
        pred, mut = jm.apply({"params": p, "batch_stats": s}, x, train=True,
                             mutable=["batch_stats"])
        total, _ = jax_combined_loss(pred.astype(jnp.float32), y, jcfg, rgb=x)
        return total, mut["batch_stats"]

    (loss_j, new_stats), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, stats, jnp.asarray(rgb), jnp.asarray(depth))

    model = copy.deepcopy(port)
    old = {k: v.clone() for k, v in model.state_dict().items()}
    counts, hooks = _bn_inputs(model)
    loss_t, _ = forward_backward(model, cfg, _nchw(rgb), torch.from_numpy(depth.copy()))
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)

    # gradients: JAX's tree in the port's names and layouts
    gj = {k: v.double() for k, v in state_dict_from_flax(jax.device_get(grads_j), None).items()}
    named = dict(model.named_parameters())
    keys = sorted(k for k in gj if k.split(".", 1)[0] != "dinov2")
    assert all(named[k].grad is not None for k in keys)
    assert all(p.grad is None for k, p in named.items() if k.startswith("dinov2."))
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

    # BN running statistics: same mean update; torch's unbiased variance
    new = state_dict_from_flax({}, jax.device_get(new_stats))
    sd = model.state_dict()
    assert {k for k in new if k.endswith("running_var")} == \
        {f"{n}.running_var" for n in counts}
    factors = []
    for name, n in counts.items():
        mean_k, var_k = f"{name}.running_mean", f"{name}.running_var"
        np.testing.assert_allclose(sd[mean_k].numpy(), new[mean_k].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=mean_k)
        biased = (new[var_k] - 0.9 * old[var_k]) / 0.1
        want = 0.9 * old[var_k] + 0.1 * biased * n / (n - 1)
        np.testing.assert_allclose(sd[var_k].numpy(), want.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=var_k)
        factors.append(n / (n - 1))
    assert max(factors) > 1.05  # the deliberate difference is visible at this size


def test_train_step_leaves_dinov2_bit_identical(flagship, batch):
    """One full step (pipeline, forward, backward, AdamW with weight decay):
    the frozen subtree does not move, and the trainable ones do."""
    port = flagship[3]
    model = copy.deepcopy(port)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, _cfg(config), make_optimizer(model, _cfg(config)))
    metrics = step(torch.from_numpy(batch[2]), torch.from_numpy(batch[3]), step_generator(0, 0, 0))
    assert set(metrics) == {"loss", "si_loss", "silog_loss", "grad_loss", "edge_loss"}
    assert np.isfinite(metrics["loss"].item())
    after = model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert not [k for k in moved if k.startswith("dinov2.")]
    assert any(k.startswith("dinov2_head.") for k in moved)
    assert any(k.startswith("pretrained.") for k in moved)


def test_accum_steps_equals_two_microbatches_by_hand(flagship):
    """accum_steps=2 on a batch of 4: per-microbatch pipeline, forward and
    backward, gradients averaged, one update; BN's running statistics see
    two momentum updates."""
    port = flagship[3]
    cfg = _cfg(config)
    rng = np.random.default_rng(5)
    u8 = torch.from_numpy(rng.integers(0, 256, (4, 60, 80, 3), dtype=np.uint8))
    depth = torch.from_numpy(rng.uniform(0.5, 5.0, (4, 60, 80)).astype(np.float32))

    a = copy.deepcopy(port)
    make_train_step(a, cfg, make_optimizer(a, cfg), accum_steps=2)(
        u8, depth, torch.Generator().manual_seed(9))

    b = copy.deepcopy(port)
    opt = make_optimizer(b, cfg)
    gen = torch.Generator().manual_seed(9)
    opt.zero_grad()
    for i in range(2):
        rgb, d = T.preprocess_train(u8[2 * i:2 * i + 2], depth[2 * i:2 * i + 2], SIZE, generator=gen)
        forward_backward(b, cfg, rgb, d, scale=0.5)
    opt.step()

    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert sa["scratch.layer1_rn.weight"].ne(port.state_dict()["scratch.layer1_rn.weight"]).any()
    bn = "fusion_head.2.num_batches_tracked"
    assert sa[bn].item() == port.state_dict()[bn].item() + 2
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(a, cfg, make_optimizer(a, cfg), accum_steps=3)(
            u8, depth, torch.Generator().manual_seed(0))


def test_step_generator_is_a_function_of_seed_epoch_and_iteration():
    def draw(*key):
        return torch.rand(4, generator=step_generator(*key))

    assert torch.equal(draw(0, 1, 2), draw(0, 1, 2))
    assert len({tuple(draw(*k).tolist()) for k in ((0, 1, 2), (0, 2, 1), (1, 1, 2), (0, 1, 3))}) == 4

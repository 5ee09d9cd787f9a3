"""The port's PairAug path (``augmentation: True``) against the JAX package's,
on the CPU.

Each operation takes the JAX package's draws, made with the ``jax.random``
calls of mde_tpu/ops/image.py:242-323 and mde_tpu/data/transforms.py:59-78,
injected into the port's math:

- ``affine_sample`` on the same affines (some map taps outside the image),
  RGB in [0, 1] and depth in the dataset's (0.1, 10]: rtol 1e-6, atol 1e-5
  on RGB and 1e-4 on depth. Both packages compute the source coordinate in
  float32 and blend the four taps in the same order, but JAX's einsum may
  sum the coordinate's three terms in another order: an ulp of a coordinate
  below 64 (3.8e-6) times the step between neighbours (1 in RGB, up to 10
  in depth).
- ``pair_geometric_affine`` with the flips and the rotations forced off and
  on (gate probabilities 0 and 1), and with JAX's own gates: rtol 1e-6,
  atol 1e-4 (cos and sin of the angle may differ by an ulp; a translation
  sums terms of up to about 600 that cancel, and an ulp there is 6e-5).
- noise: rtol 1e-6, atol 1e-7. Blur at sigma 0.1 and 2: rtol 1e-6, atol
  1e-6 (the taps' exp may differ by an ulp).
- ``pairaug_apply`` as a whole against ``mde_tpu``'s ``preprocess_pairaug``
  for four keys on a batch of six: RGB rtol 1e-5, atol 5e-5 (the jitter's
  hue step, atol 2e-6 in tests/test_torch_train.py, grows by 1/0.225 in the
  normalisation, and the depth resize's rounding moves the warp's taps),
  depth rtol 2e-5, atol 1e-4. The two packages' affines differ by up to
  2e-6 (``pair_geometric_affine``: cos and sin of the angle and the
  composition's last ulps; XLA's and torch's cos/sin are different
  approximations, so no order of operations gives JAX's bits), which moves a
  source coordinate below 64 by up to two of its ulps (3.8e-6 each; 1.5
  measured on these keys). An output is a blend of neighbouring depths, so
  such a shift moves it by the coordinate's change times the step between
  the taps it blends: up to 10 inside the image (depths in (0.1, 10]), and at
  the border, where a tap outside the image reads 0, the step is the depth
  itself, again up to 10. Two ulps times 10 is 7.6e-5; atol 1e-4 is the
  bound ``affine_sample``'s own test derives above. The align-corners depth
  resize (F.interpolate against JAX's interpolation matrices, rtol 1e-5 in
  tests/test_torch_train.py) adds to the rtol.

Also: the draws come from the generator and repeat under one seed; one
flagship train step with ``augmentation: True`` gives a finite loss and
moves the trainable parameters; the training CLI runs an epoch with
``--set augmentation=true``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.data import transforms as JT
from mde_tpu.ops import image as JI
from mde_tpu_torch.core import config
from mde_tpu_torch.data import synthetic
from mde_tpu_torch.data import transforms as T
from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
from mde_tpu_torch.nn.blocks import init_weights_
from mde_tpu_torch.ops import image as I
from mde_tpu_torch.tools import main as train_cli
from mde_tpu_torch.train.trainer import make_optimizer, make_train_step, step_generator

torch.set_num_threads(2)

DINO = (28, 42)
SIZE = (32, 48)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _nhwc(x: torch.Tensor):
    return x.permute(0, 2, 3, 1).numpy()


def _jax_geometry(key, b, hflip_p=0.5, rot_p=0.3):
    """The draws of mde_tpu/ops/image.py::pair_geometric_affine, made the same way."""
    k_area, k_top, k_left, k_flip, k_rot, k_rotp = jax.random.split(key, 6)
    return [
        jax.random.uniform(k_area, (b,), minval=0.8, maxval=1.0),
        jax.random.uniform(k_top, (b,)),
        jax.random.uniform(k_left, (b,)),
        jax.random.bernoulli(k_flip, hflip_p, (b,)).astype(jnp.float32),
        jax.random.uniform(k_rot, (b,), minval=-3.0, maxval=3.0),
        jax.random.bernoulli(k_rotp, rot_p, (b,)).astype(jnp.float32),
    ]


def _jax_jitter(key, b, brightness, contrast, saturation, hue):
    """The draws of mde_tpu/ops/image.py::color_jitter, made the same way."""
    k_b, k_c, k_s, k_h, k_perm = jax.random.split(key, 5)
    return (
        jax.random.uniform(k_b, (b,), minval=max(0.0, 1 - brightness), maxval=1 + brightness),
        jax.random.uniform(k_c, (b,), minval=max(0.0, 1 - contrast), maxval=1 + contrast),
        jax.random.uniform(k_s, (b,), minval=max(0.0, 1 - saturation), maxval=1 + saturation),
        jax.random.uniform(k_h, (b,), minval=-hue, maxval=hue),
        jax.vmap(lambda k: jax.random.permutation(k, 4))(jax.random.split(k_perm, b)),
    )


def _jax_pairaug_draws(key, b, size):
    """mde_tpu's preprocess_pairaug draws as the port's PairAugDraws, and its
    noise (NCHW)."""
    k_geo, k_jit, k_gate, k_noise, k_blur = jax.random.split(key, 5)
    k_ngate, k_nval = jax.random.split(k_noise)
    k_bgate, k_sigma = jax.random.split(k_blur)
    draws = T.PairAugDraws(
        *(_t(x) for x in _jax_geometry(k_geo, b)),
        tuple(_t(x) for x in _jax_jitter(k_jit, b, *T.PAIRAUG_JITTER)),
        _t(jax.random.bernoulli(k_gate, 0.8, (b,)).astype(jnp.float32)),
        _t(jax.random.bernoulli(k_ngate, 0.25, (b,)).astype(jnp.float32)),
        0,
        _t(jax.random.bernoulli(k_bgate, 0.2, (b,)).astype(jnp.float32)),
        _t(jax.random.uniform(k_sigma, (b,), minval=0.1, maxval=2.0)),
    )
    return draws, _nchw(jax.random.normal(k_nval, (b, *size, 3), jnp.float32))


# ---------------------------------------------------------------------------
# The operations
# ---------------------------------------------------------------------------

THETAS = np.array([
    [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],          # identity
    [[0.9, 0.0, 0.45], [0.0, 0.9, 0.35]],         # a crop inside the image
    [[-1.0, 0.0, 47.0], [0.0, 1.0, 0.0]],         # the flip
    [[1.3, 0.2, -10.0], [0.1, 1.2, -8.0]],        # taps outside on every side
    [[0.998, -0.052, 1.9], [0.052, 0.998, -1.3]],  # a 3-degree rotation
], np.float32)


@pytest.mark.parametrize("what", ["rgb", "depth"])
def test_affine_sample_matches_jax(what):
    rng = np.random.default_rng(0)
    b = len(THETAS)
    if what == "rgb":
        img, atol = rng.random((b, *SIZE, 3), dtype=np.float32), 1e-5
    else:
        img, atol = rng.uniform(0.1, 10.0, (b, *SIZE, 1)).astype(np.float32), 1e-4
    want = np.asarray(JI.affine_sample(jnp.asarray(img), jnp.asarray(THETAS)))
    got = _nhwc(I.affine_sample(_nchw(img), _t(THETAS)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    np.testing.assert_array_equal(got[0], img[0])  # the identity copies
    assert (want[3] == 0).any()  # taps outside the image were reached


@pytest.mark.parametrize("hflip_p,rot_p", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0),
                                           (0.5, 0.3)])
def test_pair_geometric_affine_matches_jax(hflip_p, rot_p):
    """Gates forced off and on (a bernoulli at p = 0 or 1), and drawn."""
    h, w = 448, 576
    key = jax.random.key(5)
    draws = _jax_geometry(key, 6, hflip_p, rot_p)
    got = I.pair_geometric_affine(*(_t(x) for x in draws), h, w).numpy()
    want = np.asarray(JI.pair_geometric_affine(key, 6, h, w, hflip_p=hflip_p, rot_p=rot_p))
    assert got.shape == (6, 2, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert bool((got[:, 0, 0] < 0).all()) == (hflip_p == 1.0)  # flipped: x runs backwards
    assert bool((got[:, 0, 1] == 0).all()) == (rot_p == 0.0)  # rotated: x reads y
    if (hflip_p, rot_p) == (0.5, 0.3):
        assert 0 < float(draws[3].sum()) < 6 and 0 < float(draws[5].sum()) < 6


def test_compose_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((2, 4, 2, 3)).astype(np.float32)
    np.testing.assert_allclose(I._compose(_t(a), _t(b)).numpy(),
                               np.asarray(JI._compose(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)


def test_random_gaussian_noise_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.random((4, *SIZE, 3), dtype=np.float32)
    key = jax.random.key(4)
    k_gate, k_noise = jax.random.split(key)
    gate = jax.random.bernoulli(k_gate, 0.5, (4,)).astype(jnp.float32)
    noise = jax.random.normal(k_noise, x.shape, jnp.float32)
    assert 0 < float(gate.sum()) < 4
    want = np.asarray(JI.random_gaussian_noise(key, jnp.asarray(x), std=0.005, p=0.5))
    got = _nhwc(I.random_gaussian_noise(_nchw(x), _t(gate), _nchw(noise), std=0.005))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sigma", [0.1, 2.0])
def test_random_gaussian_blur_matches_jax(sigma, monkeypatch):
    """JAX's sigma draw is replaced by ``sigma``; the gate is its own."""
    rng = np.random.default_rng(3)
    x = rng.random((5, *SIZE, 3), dtype=np.float32)
    key = jax.random.key(6)
    gate = jax.random.bernoulli(jax.random.split(key)[0], 0.6, (5,)).astype(jnp.float32)
    assert 0 < float(gate.sum()) < 5
    real_uniform = jax.random.uniform
    monkeypatch.setattr(jax.random, "uniform",
                        lambda k, shape, minval=0.0, maxval=1.0, **kw: jnp.full(shape, sigma))
    want = np.asarray(JI.random_gaussian_blur(key, jnp.asarray(x), 3, (0.1, 2.0), p=0.6))
    monkeypatch.setattr(jax.random, "uniform", real_uniform)
    got = _nhwc(I.random_gaussian_blur(_nchw(x), _t(gate), torch.full((5,), sigma)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    blurred = np.asarray(gate).astype(bool)
    np.testing.assert_array_equal(got[~blurred], x[~blurred])
    if sigma == 2.0:  # at 0.1 the side taps are exp(-50) of the centre
        assert not np.allclose(got[blurred], x[blurred], atol=1e-4)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_pairaug_matches_jax_with_injected_draws(seed):
    rng = np.random.default_rng(10 + seed)
    u8 = rng.integers(0, 256, (6, 30, 40, 3), dtype=np.uint8)
    depth = rng.uniform(0.1, 10.0, (6, 30, 40)).astype(np.float32)
    key = jax.random.key(seed)
    draws, noise = _jax_pairaug_draws(key, 6, SIZE)
    jrgb, jdepth = JT.preprocess_pairaug(key, jnp.asarray(u8), jnp.asarray(depth),
                                         input_size=SIZE)
    rgb, d = T.pairaug_apply(_t(u8), _t(depth), draws, SIZE, noise=noise)
    assert rgb.shape == (6, 3, *SIZE) and rgb.is_contiguous() and d.shape == (6, *SIZE)
    np.testing.assert_allclose(_nhwc(rgb), np.asarray(jrgb), rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jdepth), rtol=2e-5, atol=1e-4)


def test_pairaug_seeds_cover_every_stage():
    """The four keys above switch each stage on for some sample and off for another."""
    gates = [_jax_pairaug_draws(jax.random.key(s), 6, SIZE)[0] for s in range(4)]
    for field in ("flip", "rot_gate", "jitter_gate", "noise_gate", "blur_gate"):
        values = torch.cat([getattr(g, field) for g in gates])
        assert 0 < values.sum() < len(values), field


def test_pairaug_draws_come_from_the_generator():
    def flat(d):
        tensors = (*d[:6], *d.jitter, d.jitter_gate, d.noise_gate, d.blur_gate, d.blur_sigma)
        return torch.cat([x.float().flatten() for x in tensors])

    a = T.pairaug_draws(8, torch.Generator().manual_seed(3))
    b = T.pairaug_draws(8, torch.Generator().manual_seed(3))
    c = T.pairaug_draws(8, torch.Generator().manual_seed(4))
    assert torch.equal(flat(a), flat(b)) and a.noise_seed == b.noise_seed
    assert not torch.equal(flat(a), flat(c)) and a.noise_seed != c.noise_seed
    assert ((a.area >= 0.8) & (a.area <= 1.0)).all() and (a.angle.abs() <= 3.0).all()
    assert ((a.blur_sigma >= 0.1) & (a.blur_sigma <= 2.0)).all()
    assert sorted(a.jitter[4][0].tolist()) == [0, 1, 2, 3]
    assert all(set(getattr(a, f).tolist()) <= {0.0, 1.0}
               for f in ("flip", "rot_gate", "jitter_gate", "noise_gate", "blur_gate"))


def test_preprocess_pairaug_repeats_under_one_seed():
    """The same generator seed gives the same bits (noise included); another
    seed another batch; ``plain`` changes nothing."""
    rng = np.random.default_rng(7)
    u8 = _t(rng.integers(0, 256, (4, 30, 40, 3), dtype=np.uint8))
    depth = _t(rng.uniform(0.1, 10.0, (4, 30, 40)).astype(np.float32))
    fn = T.make_train_pipeline(True, SIZE)
    assert fn.func is T.preprocess_pairaug
    a = fn(u8, depth, generator=torch.Generator().manual_seed(1), plain=False)
    b = fn(u8, depth, generator=torch.Generator().manual_seed(1), plain=True)
    c = fn(u8, depth, generator=torch.Generator().manual_seed(2), plain=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert torch.isfinite(a[0]).all() and (a[1] >= 0).all()


def test_noise_is_drawn_from_its_seed():
    """``pairaug_apply`` without ``noise`` draws N(0, 1) from the draws' seed."""
    rng = np.random.default_rng(8)
    u8 = _t(rng.integers(0, 256, (3, 30, 40, 3), dtype=np.uint8))
    depth = _t(rng.uniform(0.1, 10.0, (3, 30, 40)).astype(np.float32))
    draws = T.pairaug_draws(3, torch.Generator().manual_seed(0))._replace(
        noise_gate=torch.ones(3))
    noise = I.standard_normal((3, 3, *SIZE), draws.noise_seed, "cpu")
    want = T.pairaug_apply(u8, depth, draws, SIZE, noise=noise)
    got = T.pairaug_apply(u8, depth, draws, SIZE)
    assert torch.equal(got[0], want[0])
    assert not torch.equal(got[0], T.pairaug_apply(u8, depth, draws, SIZE, noise=noise * 2)[0])


# ---------------------------------------------------------------------------
# The trainer and the CLI with augmentation: True
# ---------------------------------------------------------------------------


def test_flagship_train_step_with_augmentation():
    cfg = config.from_dict({"augmentation": True,
                            "framework": {"input_size": [64, 96], "compute_dtype": "float32"}})
    model = init_weights_(MidasNetSemantics(dinov2_image_size=DINO),
                          torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.depth_head[1].bias.add_(2.0)  # off the ReLU floor
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(9)
    u8 = _t(rng.integers(0, 256, (2, 60, 80, 3), dtype=np.uint8))
    depth = _t(rng.uniform(0.1, 10.0, (2, 60, 80)).astype(np.float32))
    step = make_train_step(model, cfg, make_optimizer(model, cfg))
    metrics = step(u8, depth, step_generator(0, 0, 0))
    assert np.isfinite(metrics["loss"].item()) and metrics["loss"].item() > 0
    after = model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert any(k.startswith("pretrained.") for k in moved)
    assert any(k.startswith("dinov2_head.") for k in moved)
    assert not [k for k in moved if k.startswith("dinov2.")]


def test_training_cli_runs_an_epoch_with_augmentation(tmp_path, monkeypatch):
    seen = {}
    real = T.preprocess_pairaug

    def spy(*args, **kwargs):
        seen["calls"] = seen.get("calls", 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(T, "preprocess_pairaug", spy)
    synthetic.generate(str(tmp_path / "data"), n_train=4, n_test=1, size=(60, 80), seed=2)
    history = train_cli.main([
        "--device", "cpu", "--data-dir", str(tmp_path / "data"),
        "--set", "augmentation=true", "--set", "training.n_epoch=1",
        "--set", "framework.input_size=[64, 96]", "--set", "framework.native_size=[60, 80]",
        "--set", "training.batch_size=2", "--set", "framework.num_workers=1",
        "--set", f"paths.results_dir={tmp_path / 'results'}",
        "--set", f"paths.predictions_dir={tmp_path / 'predictions'}",
        "--set", "experiment.wandb_disable=true"])
    assert len(history["train_loss"]) == 1 and np.isfinite(history["train_loss"][0])
    assert seen["calls"] >= 1  # every train step went through PairAug

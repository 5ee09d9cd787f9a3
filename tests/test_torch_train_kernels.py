"""The plain versions of the train step's kernels against the JAX package.

- K1's backward (``window_attention_backward_plain``, the CPU backward of the
  autograd Function, fed the output and row statistics of
  ``window_attention_plain_stats``) against ``jax.vjp`` of
  ``_xla_window_attention`` and of the Pallas custom VJP
  (``_pallas_window_attention``, interpret mode on the CPU), and against
  torch autograd through ``window_attention_plain``, on a ragged grid with a
  random cotangent: rtol 1e-5, atol 1e-5 in float32 (the same float32 math
  in another summation order; gradients are O(1)). bf16 inputs: the float32
  result from the stored bf16 output, rounded once to bf16. The statistics:
  ``out`` bit-equal to ``window_attention_plain``, (max, 1/sum) against
  numpy within 1e-6 relative.
- K3's train form (``preprocess_u8_train_plain``) against mde_tpu's
  ``preprocess_train`` with the JAX draws injected, once for each of the 24
  orders of the four adjustments: rtol 1e-5, atol 1e-5, the tolerance of
  ``tests/test_torch_train.py::test_preprocess_train_matches_jax_with_injected_draws``.
- The draws: ``color_jitter_draws`` then ``color_jitter_apply`` is
  ``color_jitter`` from the same generator, which is left in the same state.
- The plain switch on the CPU: ``preprocess_train(plain=True)`` and
  ``make_train_step(plain=True)`` against the defaults.
"""

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.data import transforms as JT
from mde_tpu.ops.window_attention import (
    _pallas_window_attention,
    _window_partition as jax_partition,
    _xla_window_attention,
)
from mde_tpu_torch.core import config
from mde_tpu_torch.data import transforms as T
from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
from mde_tpu_torch.ops import image as I
from mde_tpu_torch.ops import kernels as K
from mde_tpu_torch.ops.window_attention import _window_key_validity
from mde_tpu_torch.train.trainer import make_optimizer, make_train_step
from tests.test_torch_train import _jax_draws

torch.set_num_threads(2)
TOL = 1e-5
ORDERS = list(itertools.permutations(range(4)))


def _windows(seed: int, dtype=np.float32):
    """q/k/v windows of a ragged 24x40 grid (padded to 32x48, 6 windows of
    256 tokens, C = 32, 8 heads), the validity rows and a cotangent."""
    rng = np.random.default_rng(seed)
    h, w, hp, wp, ws = 24, 40, 32, 48, 16
    grids = [np.pad(rng.standard_normal((1, h, w, 32)).astype(dtype),
                    ((0, 0), (0, hp - h), (0, wp - w), (0, 0))) for _ in range(3)]
    wins = [np.array(jax_partition(jnp.asarray(x), ws)[0]) for x in grids]
    mask = _window_key_validity(h, w, hp, wp, ws)
    assert (mask == 0).any(axis=1).sum() >= 4  # ragged windows with invalid keys
    cot = rng.standard_normal(wins[0].shape).astype(dtype)
    return wins, mask, cot


def _plain_backward(q, k, v, heads, m, cot):
    """The plain backward fed the plain forward's output and statistics."""
    out, stats = K.window_attention_plain_stats(q, k, v, heads, m)
    return K.window_attention_backward_plain(q, k, v, heads, m, out, stats, cot)


def test_window_attention_backward_plain_matches_jax_vjp():
    wins, mask, cot = _windows(0)
    got = _plain_backward(*map(torch.from_numpy, wins), 8, torch.from_numpy(mask),
                          torch.from_numpy(cot))
    jw = [jnp.asarray(x) for x in wins]
    for name, fn in (("xla", _xla_window_attention), ("pallas", _pallas_window_attention)):
        _, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, 8, mask), *jw)
        for g, want in zip(got, vjp(jnp.asarray(cot))):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                       err_msg=name)


def test_window_attention_backward_plain_matches_torch_autograd():
    """The written-out math against autograd through the forward's plain
    version; an invalid key gets exactly zero dk and dv."""
    wins, mask, cot = _windows(1)
    q, k, v = (torch.from_numpy(x) for x in wins)
    m = torch.from_numpy(mask)
    got = _plain_backward(q, k, v, 8, m, torch.from_numpy(cot))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(K.window_attention_plain(*leaves, 8, m), leaves,
                               torch.from_numpy(cot))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
    invalid = (m <= 0)[None, :, :, None].expand_as(q)
    assert got[1][invalid].abs().max() == 0 and got[2][invalid].abs().max() == 0


def test_window_attention_backward_bf16_plain_is_float32_rounded_once():
    """bf16 inputs give the float32 gradients of the same (bf16-exact)
    values with delta from the stored bf16 output, as the kernel reads it,
    rounded once to bf16; autocast does not lower the math."""
    wins, mask, cot = _windows(2)
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in (*wins, cot))
    m = torch.from_numpy(mask)
    out, stats = K.window_attention_plain_stats(q, k, v, 8, m)
    assert out.dtype == torch.bfloat16 and stats.dtype == torch.float32
    got = K.window_attention_backward_plain(q, k, v, 8, m, out, stats, g)
    want = K.window_attention_backward_plain(*(x.float() for x in (q, k, v)), 8, m,
                                             out.float(), stats, g.float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        again = K.window_attention_backward_plain(q, k, v, 8, m, out, stats, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _empty_windows(seed: int, dtype=np.float32):
    """q/k/v windows of an 8x16 grid padded to 16x16 in 8x8 windows (T = 64,
    C = 32, 8 heads): the two bottom windows hold no valid key."""
    rng = np.random.default_rng(seed)
    grids = [rng.standard_normal((1, 16, 16, 32)).astype(dtype) for _ in range(3)]
    wins = [np.array(jax_partition(jnp.asarray(x), 8)[0]) for x in grids]
    mask = _window_key_validity(8, 16, 16, 16, 8)
    assert (mask.max(axis=1) == 0).sum() == 2
    return wins, mask


@pytest.mark.parametrize("grid", ["ragged", "empty_windows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_window_attention_plain_stats_matches_numpy(dtype, grid):
    """``out`` is bit-equal to ``window_attention_plain``; (max, 1/sum) of
    the masked, scaled logits match numpy (float64) within 1e-6 relative. In
    a window with no valid key the max is exactly the float32 minimum and
    1/sum exactly 1/T: the kernel's forward writes the same."""
    wins, mask = _windows(3)[:2] if grid == "ragged" else _empty_windows(3)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in wins)
    m = torch.from_numpy(mask)
    out, stats = K.window_attention_plain_stats(q, k, v, 8, m)
    assert torch.equal(out, K.window_attention_plain(q, k, v, 8, m))
    b, n, t, c = q.shape
    assert stats.shape == (b, n, 8, t, 2) and stats.dtype == torch.float32 and stats.is_contiguous()
    qh, kh = (x.float().numpy().astype(np.float64).reshape(b, n, t, 8, c // 8) for x in (q, k))
    logits = np.einsum("bnqhd,bnkhd->bnhqk", qh, kh) * (c // 8) ** -0.5
    logits = np.where((mask > 0)[None, :, None, None, :], logits, np.finfo(np.float32).min)
    want_m = logits.max(-1)
    want_inv = 1.0 / np.exp(logits - want_m[..., None]).sum(-1)
    np.testing.assert_allclose(stats[..., 0].numpy(), want_m, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(stats[..., 1].numpy(), want_inv, rtol=1e-6, atol=0)
    empty = torch.from_numpy(mask.max(axis=1) <= 0)
    if grid == "empty_windows":
        assert bool((stats[:, empty, ..., 0] == torch.finfo(torch.float32).min).all())
        assert bool((stats[:, empty, ..., 1] == 1.0 / t).all())
    else:
        assert not empty.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_window_attention_function_matches_autograd_through_plain(dtype):
    """The autograd Function on the CPU (forward with statistics, then the
    plain backward) against autograd through ``window_attention_plain``:
    float32 within 1e-5; bf16 within 2e-2 rel-L2, the card's bound for the
    bf16 backward kernel (delta from the rounded output)."""
    wins, mask, cot = _windows(4)
    m = torch.from_numpy(mask)
    g = torch.from_numpy(cot).to(dtype)
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in wins]
    got = torch.autograd.grad(K.window_attention(*leaves, 8, m), leaves, g)
    ref = [x.detach().float().requires_grad_() for x in leaves]
    want = torch.autograd.grad(K.window_attention_plain(*ref, 8, m), ref, g.float())
    for a, w in zip(got, want):
        assert a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, rtol=TOL, atol=TOL)
        else:
            assert ((a.float() - w).norm() / w.norm()).item() <= 2e-2


def test_window_attention_asks_for_stats_only_under_grad(monkeypatch):
    """The forward is asked for the row statistics only when a backward can
    follow: grad mode on and an input that requires grad."""
    asked = []
    real = K._window_attention_forward
    monkeypatch.setattr(K, "_window_attention_forward",
                        lambda *a: asked.append(a[-1]) or real(*a))
    wins, mask, cot = _windows(5)
    q, k, v = (torch.from_numpy(x) for x in wins)
    m = torch.from_numpy(mask)
    K.window_attention(q, k, v, 8, m)
    with torch.no_grad():
        K.window_attention(q.requires_grad_(), k, v, 8, m)
    with torch.inference_mode():
        K.window_attention(q, k, v, 8, m)
    out = K.window_attention(q, k, v, 8, m)
    assert asked == [False, False, False, True]
    out.backward(torch.from_numpy(cot))
    assert q.grad is not None and q.grad.shape == q.shape


@pytest.fixture(scope="module")
def order_keys():
    """For each of the 24 orders, a JAX key whose one-sample colour jitter
    draws that order (mde_tpu/ops/image.py::color_jitter)."""
    def perm(seed):
        k_perm = jax.random.split(jax.random.key(seed), 5)[4]
        return jax.random.permutation(jax.random.split(k_perm, 1)[0], 4)

    perms = np.asarray(jax.jit(jax.vmap(perm))(jnp.arange(600)))
    keys = {}
    for seed, p in enumerate(perms):
        keys.setdefault(tuple(int(x) for x in p), seed)
    assert len(keys) == 24
    return keys


@pytest.mark.parametrize("order", ORDERS, ids=["".join(map(str, o)) for o in ORDERS])
def test_preprocess_u8_train_plain_matches_jax_preprocess_train(order, order_keys):
    """u8 -> resize -> jitter in this order -> normalise, with JAX's draws."""
    seed = order_keys[order]
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (1, 30, 40, 3), dtype=np.uint8)
    u8[0, :2, :2] = [255, 0, 0]  # a saturated corner and a grey one take the edge branches
    u8[0, -2:, -2:] = 128
    depth = rng.uniform(0.5, 10.0, (1, 30, 40)).astype(np.float32)
    key = jax.random.key(seed)
    draws = _jax_draws(key, 1)
    assert tuple(draws[-1][0].tolist()) == order
    got = K.preprocess_u8_train_plain(torch.from_numpy(u8), K.pack_jitter_draws(*draws), (32, 48))
    want, _ = JT.preprocess_train(key, jnp.asarray(u8), jnp.asarray(depth), input_size=(32, 48))
    assert got.shape == (1, 3, 32, 48) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=TOL, atol=TOL)


def test_color_jitter_draws_then_apply_is_color_jitter():
    x = torch.rand(5, 3, 8, 10, generator=torch.Generator().manual_seed(0))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    want = I.color_jitter(x, 0.2, 0.2, 0.2, 0.1, generator=g1)
    draws = I.color_jitter_draws(5, 0.2, 0.2, 0.2, 0.1, generator=g2)
    assert torch.equal(I.color_jitter_apply(x, *draws), want)
    assert [d.dtype for d in draws] == [torch.float32] * 4 + [torch.int64]
    assert sorted(draws[-1][0].tolist()) == [0, 1, 2, 3]
    assert torch.equal(torch.rand(3, generator=g1), torch.rand(3, generator=g2))


def test_preprocess_u8_train_is_preprocess_train_on_cpu():
    """The wrapper (its plain version on the CPU), fed the packed draws of
    the step's generator, is ``preprocess_train``'s image bit for bit, and
    launches nothing; ``plain=True`` changes nothing on the CPU."""
    rng = np.random.default_rng(4)
    u8 = torch.from_numpy(rng.integers(0, 256, (3, 30, 40, 3), dtype=np.uint8))
    depth = torch.from_numpy(rng.uniform(0.5, 10.0, (3, 30, 40)).astype(np.float32))
    launches = K.preprocess_u8_train.launches
    rgb, d = T.preprocess_train(u8, depth, (32, 48), generator=torch.Generator().manual_seed(3))
    rgb_p, d_p = T.preprocess_train(u8, depth, (32, 48), generator=torch.Generator().manual_seed(3),
                                    plain=True)
    draws = I.color_jitter_draws(3, *T.JITTER, generator=torch.Generator().manual_seed(3))
    packed = K.pack_jitter_draws(*draws)
    assert packed.shape == (3, K.JITTER_DRAWS) and packed.dtype == torch.float32
    assert torch.equal(K.preprocess_u8_train(u8, packed, (32, 48)), rgb)
    assert torch.equal(K.preprocess_u8_train_plain(u8, packed, (32, 48)), rgb)
    assert torch.equal(rgb_p, rgb) and torch.equal(d_p, d)
    assert K.preprocess_u8_train.launches == launches


def test_make_train_step_plain_switch_on_cpu():
    """One flagship step at 64x96 (DINOv2 at 28x42) with ``plain=True`` and
    without: the same pipeline output and loss bit for bit (the forward is
    the same plain code on the CPU), gradients within 1e-5 rel-L2 (K1 and
    K2's written-out backwards against autograd through their plain
    forwards)."""
    cfg = config.defaults()
    cfg.framework.input_size = [64, 96]
    cfg.framework.compute_dtype = "float32"
    torch.manual_seed(0)
    base = MidasNetSemantics(dinov2_image_size=(28, 42))
    rng = np.random.default_rng(6)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 60, 80, 3), dtype=np.uint8))
    depth = torch.from_numpy(rng.uniform(0.5, 5.0, (2, 60, 80)).astype(np.float32))
    models, metrics = [], []
    for plain in (False, True):
        model = copy.deepcopy(base)
        step = make_train_step(model, cfg, make_optimizer(model, cfg), plain=plain)
        metrics.append(step(u8, depth, torch.Generator().manual_seed(8)))
        models.append(model)
    assert all(torch.equal(metrics[0][k], metrics[1][k]) for k in metrics[0])
    grads = [torch.cat([p.grad.flatten() for p in m.parameters() if p.grad is not None])
             for m in models]
    assert grads[0].shape == grads[1].shape and grads[0].norm() > 0
    assert ((grads[0] - grads[1]).norm() / grads[1].norm()).item() < 1e-5

"""K4 (``ops.kernels.flash_attention``) on the CPU: its plain version against
the JAX package's Pallas kernel (interpret mode) and its einsum reference,
the plain versions of what the kernels write for and compute in the backward
(the log-sum-exp, and the backward from it) against ``jax.nn.logsumexp`` and
``jax.vjp``, the Function's gradient, its bf16 form, and the wrapper's checks.

Tolerances: forward rtol 1e-4, atol 1e-5, the bound of the JAX package's own
flash test (tests/test_pallas_kernels.py:159): float32 logits and softmax in
another summation order (the largest gap measured is 7e-7 on O(1) outputs).
Gradients rel-L2 1e-5. The bf16 form is the float32 result of the same bf16
values rounded once, so it is within bf16's unit roundoff of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.ops.flash_attention import attention_reference, flash_attention as jax_flash
from mde_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

# (B, N, H, D): the flagship's DINOv2 branch, a ragged tile, N one below and
# one above the backward kernel's 128-row edge (and past 64), and one token.
SHAPES = {"dinov2_branch": (2, 321, 6, 64), "ragged": (1, 130, 6, 64),
          "n127": (1, 127, 2, 64), "n129": (1, 129, 2, 64), "one_token": (2, 1, 2, 64)}


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _rel_l2(a, b):
    """rel-L2 of a against b; 0 where they agree exactly (at one token dq and
    dk are exactly 0 in both: the softmax over one key has no gradient)."""
    num, den = float(np.linalg.norm(a - b)), float(np.linalg.norm(b))
    return 0.0 if num == 0 else (num / den if den > 0 else float("inf"))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_matches_jax_kernel_and_reference(case):
    q, k, v = _qkv(0, SHAPES[case])
    got = K.flash_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for name, fn in (("pallas", jax_flash), ("reference", attention_reference)):
        want = np.asarray(fn(jq, jk, jv))
        assert got.shape == want.shape == SHAPES[case]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_gradient_matches_jax_vjp(case, monkeypatch):
    """Autograd through the wrapper (plain forward with the log-sum-exp, and
    the Function's backward through ``flash_attention_backward_plain``, the
    backward kernel's math, on the CPU) against ``jax.vjp`` of the reference."""
    calls = []
    real = K.flash_attention_backward_plain
    monkeypatch.setattr(K, "flash_attention_backward_plain",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = _qkv(1, SHAPES[case])
    cot = np.random.default_rng(2).standard_normal(SHAPES[case]).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    K.flash_attention(*leaves).backward(torch.from_numpy(cot))
    assert calls == [1]
    _, vjp = jax.vjp(attention_reference, *map(jnp.asarray, (q, k, v)))
    for name, t, j in zip("qkv", leaves, vjp(jnp.asarray(cot))):
        rel = _rel_l2(t.grad.numpy(), np.asarray(j))
        assert rel <= 1e-5, f"d{name} rel-L2 {rel:.3e}"


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_lse_matches_jax_logsumexp(case):
    """``flash_attention_plain_lse``: the output of ``flash_attention_plain``
    bit for bit, and the rows' log-sum-exp of the scaled logits, (B, H, N),
    against ``jax.nn.logsumexp`` at rtol 1e-5 (float32 sums in another order)."""
    q, k, v = _qkv(4, SHAPES[case])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = K.flash_attention_plain_lse(tq, tk, tv)
    assert torch.equal(out, K.flash_attention_plain(tq, tk, tv))
    b, n, h, d = SHAPES[case]
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32
    logits = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), jnp.asarray(k)) * d**-0.5
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, axis=-1)),
                               rtol=1e-5)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_backward_plain_matches_jax_vjp(case):
    """``flash_attention_backward_plain`` (P from the lse, delta, dS and the
    three products) against ``jax.vjp`` of the reference: rel-L2 1e-5."""
    q, k, v = _qkv(5, SHAPES[case])
    cot = np.random.default_rng(6).standard_normal(SHAPES[case]).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = K.flash_attention_plain_lse(tq, tk, tv)
    got = K.flash_attention_backward_plain(tq, tk, tv, out, lse, torch.from_numpy(cot))
    _, vjp = jax.vjp(attention_reference, *map(jnp.asarray, (q, k, v)))
    for name, t, j in zip("qkv", got, vjp(jnp.asarray(cot))):
        assert t.shape == SHAPES[case] and t.dtype == torch.float32
        rel = _rel_l2(t.numpy(), np.asarray(j))
        assert rel <= 1e-5, f"d{name} rel-L2 {rel:.3e}"


def test_bf16_backward_plain_is_close_to_autograd():
    """bf16: the plain backward, fed the bf16-rounded output as the kernel
    is, against autograd through the float32 math of the same bf16 values:
    rel-L2 2e-2, the card's bound for the bf16 backward kernel (the rounded
    output moves delta by bf16's unit roundoff, and each gradient is rounded
    to bf16 once)."""
    q, k, v, cot = (torch.from_numpy(x).to(torch.bfloat16)
                    for x in _qkv(7, SHAPES["ragged"]) + [_qkv(8, SHAPES["ragged"])[0]])
    out, lse = K.flash_attention_plain_lse(q, k, v)
    assert out.dtype == torch.bfloat16
    got = K.flash_attention_backward_plain(q, k, v, out, lse, cot)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(K.flash_attention_plain(*leaves), leaves, cot.float())
    for name, t, w in zip("qkv", got, want):
        assert t.dtype == torch.bfloat16
        rel = ((t.float() - w).norm() / w.norm()).item()
        assert rel <= 2e-2, f"d{name} rel-L2 {rel:.3e}"


def test_wrapper_asks_for_lse_only_under_grad(monkeypatch):
    """The forward is asked for the log-sum-exp only when a backward can
    follow: grad mode on and an input that requires grad."""
    asked = []
    real = K._flash_attention_forward
    monkeypatch.setattr(K, "_flash_attention_forward",
                        lambda q, k, v, need_lse: asked.append(need_lse) or real(q, k, v, need_lse))
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, (1, 20, 2, 64)))
    K.flash_attention(q, k, v)
    with torch.no_grad():
        K.flash_attention(q.requires_grad_(), k, v)
    with torch.inference_mode():
        K.flash_attention(q, k, v)
    out = K.flash_attention(q, k, v)
    assert asked == [False, False, False, True]
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape


def test_backward_counters_do_not_move_on_cpu():
    """A CPU forward and backward in both dtypes launch nothing: no count moves."""
    names = ("launches", "bf16_launches", "backward_launches", "backward_bf16_launches")
    before = [getattr(K.flash_attention, a) for a in names]
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in _qkv(10, (2, 33, 2, 64))]
        K.flash_attention(*leaves).float().square().sum().backward()
        assert all(x.grad is not None and x.grad.dtype == dtype for x in leaves)
    assert [getattr(K.flash_attention, a) for a in names] == before


def test_bf16_plain_is_float32_rounded_once():
    """bf16 inputs give the float32 result of the same (bf16-exact) values,
    rounded once: max-abs 1e-2 and within 2^-8 relative; autocast does not
    lower the math."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(3, SHAPES["ragged"]))
    got = K.flash_attention_plain(q, k, v)
    want = K.flash_attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    assert (got.float() - want).abs().max().item() <= 1e-2
    assert ((got.float() - want).abs() <= want.abs() * 2.0**-8).all()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert torch.equal(K.flash_attention_plain(q, k, v), got)


def test_wrapper_takes_plain_version_on_cpu_and_reads_qkv_views():
    """On a CPU tensor the plain version runs and nothing is launched; the
    (B, N, 3, H, D) views of a fused qkv projection pass the kernel's checks."""
    before = (K.flash_attention.launches, K.flash_attention.bf16_launches)
    qkv = torch.randn(2, 65, 3, 6, 64)
    q, k, v = qkv.unbind(2)
    assert torch.equal(K.flash_attention(q, k, v), K.flash_attention_plain(q, k, v))
    x = qkv.to(torch.bfloat16).unbind(2)
    assert K.flash_attention(*x).dtype == torch.bfloat16
    assert (K.flash_attention.launches, K.flash_attention.bf16_launches) == before
    assert K._flash_shape(q, k, v) == (2, 65, 6, 64)


def test_wrapper_checks_raise():
    meta = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.flash_attention(meta, meta, meta)
    x = torch.randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match="head dim 32"):
        K._flash_shape(*(torch.randn(1, 8, 4, 32),) * 3)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        K._flash_shape(x, x, x.half())
    with pytest.raises(ValueError, match="share a"):
        K._flash_shape(x, x, torch.randn(1, 9, 2, 64))
    with pytest.raises(ValueError, match="strides"):
        t = x.transpose(1, 2).contiguous().transpose(1, 2)  # heads outermost
        K._flash_shape(t, t, t)
    with pytest.raises(ValueError, match="strides"):
        t = torch.randn(1, 8, 132)[..., :128].view(1, 8, 2, 64)  # token stride 132
        K._flash_shape(t, t, t)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t = torch.randn(1 + 8 * 128)[1:].view(1, 8, 2, 64)
        K._flash_shape(t, t, t)
    with pytest.raises(ValueError, match="one device"):
        K._flash_shape(x, x, meta)

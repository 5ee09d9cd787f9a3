"""K4 (``ops.kernels.flash_attention``) on the CPU: its plain version against
the JAX package's Pallas kernel (interpret mode) and its einsum reference,
its recompute gradient against ``jax.vjp``, its bf16 form, and the wrapper's
checks.

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

SHAPES = {"dinov2_branch": (2, 321, 6, 64), "ragged": (1, 130, 6, 64)}


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


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
def test_gradient_matches_jax_vjp(case):
    """Autograd through the wrapper (plain forward and the Function's
    recompute backward on the CPU) against ``jax.vjp`` of the reference."""
    q, k, v = _qkv(1, SHAPES[case])
    cot = np.random.default_rng(2).standard_normal(SHAPES[case]).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    K.flash_attention(*leaves).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(attention_reference, *map(jnp.asarray, (q, k, v)))
    for name, t, j in zip("qkv", leaves, vjp(jnp.asarray(cot))):
        rel = _rel_l2(t.grad.numpy(), np.asarray(j))
        assert rel <= 1e-5, f"d{name} rel-L2 {rel:.3e}"


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

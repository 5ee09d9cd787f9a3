"""The port's kernel modules (mde_tpu_torch/ops/kernels.py) against the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version, so these tests
hold the plain versions against the JAX functions they port: the XLA path and
the Pallas kernel in interpret mode. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py.

Tolerance: atol 1e-5 (rtol 1e-5 for gradients) in float32. Both sides compute
the same float32 math in a different summation order; attention outputs and
normalised pixels are O(1), so rounding stays near 1e-6. The bf16 plain
version is held to the float32 one within bf16's unit roundoff, 2^-8. K2's plain
version is held against JAX in tests/test_torch_losses.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.data.transforms import preprocess_eval
from mde_tpu.ops.pallas_kernels import normalize_u8_fused, window_attention_fused
from mde_tpu.ops.window_attention import (
    _window_key_validity as jax_key_validity,
    _window_partition as jax_partition,
    _xla_window_attention,
    windowed_cross_attention as jax_windowed,
)
from mde_tpu_torch.ops import kernels as K
from mde_tpu_torch.ops.window_attention import (
    _window_key_validity,
    _window_partition,
    _window_unpartition,
    windowed_cross_attention,
)

torch.set_num_threads(2)
ATOL = 1e-5

# (B, H, W, C, heads, window): aligned, ragged (8-wide right remainder, as the
# flagship's 56x72 grid), and several ragged windows in both axes.
GRIDS = {
    "aligned": (1, 32, 32, 16, 4, 16),
    "ragged": (2, 16, 24, 32, 8, 16),
    "multi_window": (1, 40, 56, 16, 4, 16),
}


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_windowed_attention_matches_jax_xla_and_pallas(grid):
    b, h, w, c, heads, ws = GRIDS[grid]
    q, k, v = _qkv(np.random.default_rng(0), (b, h, w, c))
    got = windowed_cross_attention(*map(torch.from_numpy, (q, k, v)), heads, ws).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for backend in ("xla", "pallas"):
        want = np.asarray(jax_windowed(jq, jk, jv, heads, ws, backend=backend))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=backend)


# (B, H, W, C, heads, window, padded H, padded W) of the (B, N, T, C) op's
# cases: the flagship's ragged validity rows, a grid whose bottom windows hold
# no valid key (their rows attend evenly to all keys), 10x10 windows (T = 100,
# ragged in the kernel's chunks and slices), head_dim 8 and head_dim 16.
WINDOW_CASES = {
    "ragged": (1, 24, 40, 32, 8, 16, 32, 48),
    "empty_bottom_windows": (1, 8, 16, 32, 8, 8, 16, 16),
    "window10": (1, 14, 18, 32, 8, 10, 20, 20),
    "head_dim8": (1, 16, 16, 32, 4, 8, 16, 16),
    "head_dim16": (1, 12, 16, 64, 4, 8, 16, 16),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_attention_plain_matches_jax_on_windows(case):
    """The (B, N, T, C) op itself against the XLA path and the Pallas kernel
    (interpret mode), on windows of a padded grid with random values in the
    padding too."""
    rng = np.random.default_rng(1)
    b, h, w, c, heads, ws, hp, wp = WINDOW_CASES[case]
    wins = [np.array(jax_partition(jnp.asarray(x), ws)[0]) for x in _qkv(rng, (b, hp, wp, c))]
    mask = _window_key_validity(h, w, hp, wp, ws)
    np.testing.assert_array_equal(mask, jax_key_validity(h, w, hp, wp, ws))
    if case == "empty_bottom_windows":
        assert (mask.max(axis=1) == 0).sum() == 2
    got = K.window_attention_plain(*map(torch.from_numpy, wins), heads, torch.from_numpy(mask))
    jw = [jnp.asarray(x) for x in wins]
    for want in (_xla_window_attention(*jw, heads, mask),
                 window_attention_fused(*jw, heads, mask)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_window_partition_round_trip():
    x = torch.arange(2 * 32 * 48 * 3, dtype=torch.float32).reshape(2, 32, 48, 3)
    w, nh, nw = _window_partition(x, 16)
    assert w.shape == (2, 6, 256, 3) and (nh, nw) == (2, 3)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jax_partition(jnp.asarray(x.numpy()), 16)[0]))
    assert torch.equal(_window_unpartition(w, 16, nh, nw), x)


def test_window_attention_backward_matches_jax_vjp():
    """The autograd Function's backward (on the CPU, the backward kernel's
    plain version) vs ``jax.vjp`` through the Pallas custom VJP, on a ragged
    grid with a random cotangent."""
    rng = np.random.default_rng(2)
    b, h, w, c, heads, ws = 1, 24, 40, 16, 4, 16
    q, k, v = _qkv(rng, (b, h, w, c))
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = windowed_cross_attention(tq, tk, tv, heads, ws)
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b_, c_: jax_windowed(a, b_, c_, heads, ws, backend="pallas"),
                     *map(jnp.asarray, (q, k, v)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("shape,size", [
    ((2, 426, 560, 3), (448, 576)),  # the serving path's resize
    ((3, 37, 53, 3), (64, 96)),      # odd sizes, upsample
    ((1, 90, 70, 3), (45, 56)),      # downsample
])
def test_preprocess_u8_plain_matches_preprocess_eval(shape, size):
    u8 = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    got = K.preprocess_u8_plain(torch.from_numpy(u8), size).numpy()
    want = np.asarray(preprocess_eval(jnp.asarray(u8), None, input_size=size, has_depth=False))
    assert got.shape == (shape[0], 3) + tuple(size)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0, atol=ATOL)


def test_preprocess_u8_plain_matches_normalize_u8_fused():
    """Same size in and out: the resize is the identity, leaving the map of
    the Pallas kernel (interpret mode)."""
    u8 = np.random.default_rng(4).integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    got = K.preprocess_u8_plain(torch.from_numpy(u8), (16, 24)).numpy()
    want = np.asarray(normalize_u8_fused(jnp.asarray(u8)))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0, atol=ATOL)


def test_wrappers_take_plain_version_on_cpu_only():
    """On a CPU tensor a wrapper runs the plain version and launches nothing
    (K1's backward and K3's train form too); on any other device that is not
    CUDA it raises rather than falling back."""
    def counts():
        return (K.window_attention.launches, K.window_attention.backward_launches,
                K.window_attention.bf16_backward_launches, K.preprocess_u8.launches,
                K.preprocess_u8_train.launches)

    before = counts()
    x = torch.randn(1, 2, 16, 8)
    mask = torch.ones(2, 16)
    mask[1, ::3] = 0
    assert torch.equal(K.window_attention(x, x, x, 2, mask), K.window_attention_plain(x, x, x, 2, mask))
    leaves = [torch.randn(1, 2, 16, 8).requires_grad_() for _ in range(3)]
    cot = torch.randn(1, 2, 16, 8)
    got = torch.autograd.grad(K.window_attention(*leaves, 2, mask), leaves, cot)
    detached = [t.detach() for t in leaves]
    out, stats = K.window_attention_plain_stats(*detached, 2, mask)
    want = K.window_attention_backward_plain(*detached, 2, mask, out, stats, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    u8 = torch.zeros(1, 4, 4, 3, dtype=torch.uint8)
    assert torch.equal(K.preprocess_u8(u8, (4, 4)), K.preprocess_u8_plain(u8, (4, 4)))
    draws = torch.tensor([[1.1, 0.9, 1.0, 0.05, 3, 1, 0, 2]])
    assert torch.equal(K.preprocess_u8_train(u8, draws, (4, 4)),
                       K.preprocess_u8_train_plain(u8, draws, (4, 4)))
    assert counts() == before
    meta = torch.empty(1, 2, 16, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.window_attention(meta, meta, meta, 2, mask.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        K._window_attention_backward(meta, meta, meta, 2, mask.to("meta"), meta,
                                     torch.empty(1, 2, 2, 16, 2, device="meta"), meta)
    meta_u8 = torch.empty(1, 4, 4, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.preprocess_u8(meta_u8, (4, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        K.preprocess_u8_train(meta_u8, draws, (4, 4))


def test_build_fails_loudly_without_nvcc(tmp_path, monkeypatch):
    """No nvcc, no library: the build raises instead of leaving a stub."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_sources(tmp_path, monkeypatch):
    """The library is named by a hash of every csrc/*.cu, so an edited source
    gets a new build instead of a stale one."""
    for src in K.CSRC_DIR.glob("*.cu"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(K, "CSRC_DIR", tmp_path)
    before = K.library_path()
    assert before.parent == K.BUILD_DIR and before.name.startswith("libmde_kernels_")
    assert K.library_path() == before
    with open(tmp_path / "preprocess.cu", "a") as f:
        f.write("// edited\n")
    assert K.library_path() != before


def test_training_wrappers_take_plain_version_on_cpu_only():
    """K2 forward and backward and K1's bf16 form: on a CPU tensor the plain
    version runs and nothing is launched; on a meta tensor they raise."""
    counters = (K.si_loss_sums.launches, K.si_loss_sums.backward_launches,
                K.window_attention.launches, K.window_attention.bf16_launches)
    pred = (torch.rand(2, 5, 7) + 0.1).requires_grad_()
    target = torch.rand(2, 5, 7) + 0.1
    s1, s2 = K.si_loss_sums(pred, target)
    p1, p2 = K.si_loss_sums_plain(pred, target)
    assert torch.equal(s1, p1) and torch.equal(s2, p2)
    (s1.sum() + s2.sum()).backward()
    want, _ = K.si_loss_sums_backward_plain(pred.detach(), target, torch.ones(2), torch.ones(2),
                                            1e-6, False)
    assert torch.equal(pred.grad, want)
    x = torch.randn(1, 2, 16, 8).to(torch.bfloat16)
    mask = torch.ones(2, 16)
    got = K.window_attention(x, x, x, 2, mask)
    assert got.dtype == torch.bfloat16 and torch.equal(got, K.window_attention_plain(x, x, x, 2, mask))
    assert (K.si_loss_sums.launches, K.si_loss_sums.backward_launches,
            K.window_attention.launches, K.window_attention.bf16_launches) == counters
    meta = torch.empty(2, 5, 7, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.si_loss_sums(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        K.window_attention(*(torch.empty(1, 2, 16, 8, dtype=torch.bfloat16, device="meta"),) * 3,
                           2, mask.to("meta"))


def test_window_attention_bf16_plain_is_float32_rounded_once():
    """The plain version is the reference of both kernel forms: bf16 inputs
    give the float32 result of the same (bf16-exact) values, rounded once to
    bf16, i.e. within bf16's unit roundoff (2^-8 relative) of it."""
    rng = np.random.default_rng(5)
    b, h, w, c, heads, ws = 1, 24, 40, 32, 8, 16
    grids = [np.pad(x, ((0, 0), (0, 8), (0, 8), (0, 0))) for x in _qkv(rng, (b, h, w, c))]
    wins = [_window_partition(torch.from_numpy(x), ws)[0].contiguous().to(torch.bfloat16)
            for x in grids]
    mask = torch.from_numpy(_window_key_validity(h, w, h + 8, w + 8, ws))
    got = K.window_attention_plain(*wins, heads, mask)
    want = K.window_attention_plain(*(x.float() for x in wins), heads, mask)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    assert ((got.float() - want).abs() <= want.abs() * 2.0**-8).all()
    with torch.autocast("cpu", dtype=torch.bfloat16):  # autocast does not lower the math
        assert torch.equal(K.window_attention_plain(*wins, heads, mask), got)


def test_library_name_follows_the_si_loss_source(tmp_path, monkeypatch):
    for src in K.CSRC_DIR.glob("*.cu"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / "si_loss.cu").exists()
    monkeypatch.setattr(K, "CSRC_DIR", tmp_path)
    before = K.library_path()
    with open(tmp_path / "si_loss.cu", "a") as f:
        f.write("// edited\n")
    assert K.library_path() != before


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """With a stand-in nvcc that logs its arguments: one ``-c`` per source,
    all started before the link, one ``-shared`` link of the objects, and no
    object left behind."""
    log = tmp_path / "calls.txt"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n"
                    f'echo "$@" >> "{log}"\n'
                    'while [ "$#" -gt 1 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n')
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}:{os.environ['PATH']}")
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    so = K.build()
    assert so.exists() and so.parent == tmp_path / "build"
    calls = log.read_text().splitlines()
    sources = sorted(p.name for p in K.CSRC_DIR.glob("*.cu"))
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == sources
    assert "-shared" in calls[-1] and calls[-1].count(".o") == len(sources)
    assert sorted(p.name for p in so.parent.iterdir()) == [so.name]

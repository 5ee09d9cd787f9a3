"""The port's Depth-Anything-V2 against the JAX package's, on the CPU at float32.

DA-V2-S at full width (384 wide, 12 blocks, 6 heads, DPT head at features
64) on small images. The JAX module is initialised once per module, its
LayerScale gammas drawn in [0.2, 0.8] (fresh ones are 1e-5, and the
attention would move the output by 1e-5 of its size: any attention would
pass) and the depth tail's final bias raised by 0.5 (otherwise the last ReLU
zeroes most of the map), as tests/test_da2_torch_parity.py does. Its weights
reach the port through ``state_dict_from_flax(..., "DepthAnythingV2")``.

Tolerance: rtol 2e-3, atol 2e-4 and corrcoef > 0.9999, the bounds of
tests/test_da2_torch_parity.py: float32 rounding through 12 blocks, the DPT
head and three resizes. The largest gap measured at 112x140 is 6e-8 on
depths of 0.39-0.44, so rtol 1e-6, atol 1e-6 is asserted too; without the
attention branches (ls1 gammas 0) the output moves by more than 1e-3.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.models.depth_anything import DepthAnythingV2 as JDepthAnythingV2
from mde_tpu.train.torch_import import import_state_dict, map_depth_anything_key
from mde_tpu_torch.core import config
from mde_tpu_torch.models.depth_anything import DEAD_KEY_PREFIXES, DepthAnythingV2
from mde_tpu_torch.models.factory import build_model
from mde_tpu_torch.nn.blocks import init_weights_
from mde_tpu_torch.tools.common import live_missing_keys
from mde_tpu_torch.train.checkpoint import load_state_dict
from mde_tpu_torch.train.convert import state_dict_from_flax
from tests.test_torch_modules import _randomize
from tests.torch_da2_ref import DepthAnythingV2Torch

torch.set_num_threads(2)

SIZE = (112, 140)  # 8x10 tokens: off the 37x37 grid, so the bicubic pos-embed path runs


def _dead(key: str) -> bool:
    return key.startswith(DEAD_KEY_PREFIXES)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def da2_params(size, seed: int = 0, bias: float = 0.5):
    """JAX DA-V2-S parameters with O(0.5) gammas and the final bias raised."""
    jm = JDepthAnythingV2(size="vits")
    variables = jax.jit(lambda k: jm.init(k, jnp.zeros((1, *size, 3))))(jax.random.key(seed))
    params = _randomize(variables["params"], np.random.default_rng(seed))
    params["final"]["Conv_0"]["bias"] += bias
    return jm, params


@pytest.fixture(scope="module")
def da2():
    jm, params = da2_params(SIZE)
    port = DepthAnythingV2("vits").eval()
    report = load_state_dict(port, state_dict_from_flax(params, {}, "DepthAnythingV2"))
    return jm, params, port, report


def test_state_dict_is_the_release_grammar():
    """Keys and shapes of the release DA-V2-S (tests/torch_da2_ref.py)."""
    want = {k: tuple(v.shape) for k, v in DepthAnythingV2Torch().state_dict().items()}
    with torch.device("meta"):
        got = {k: tuple(v.shape) for k, v in DepthAnythingV2("vits").state_dict().items()}
    assert got == want


def test_weights_carry_over_completely(da2):
    _, _, port, report = da2
    assert not report["unexpected"] and not report["shape_mismatch"]
    assert sorted(report["missing"]) == sorted(k for k in port.state_dict() if _dead(k))
    assert live_missing_keys(port, report) == []
    assert report["missing"]  # the dead keys exist, as in a release checkpoint


def test_forward_matches_jax(da2):
    jm, params, port, _ = da2
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (2, *SIZE, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
        plain = port(_nchw(x), plain=True).numpy()
    assert got.shape == want.shape == (2, *SIZE)
    assert float(want.std()) > 1e-3 and (want > 0).mean() > 0.5  # not clipped to a constant
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(plain, got)  # on the CPU both routes are the plain version
    no_attention = copy.deepcopy(port)
    with torch.no_grad():
        for blk in no_attention.pretrained.blocks:
            blk.ls1.gamma.zero_()
        assert np.abs(no_attention(_nchw(x)).numpy() - got).max() > 1e-3


def test_metric_head_matches_jax_and_is_bounded(da2):
    """``max_depth``: sigmoid * max_depth in place of the final ReLU."""
    _, params, port, _ = da2
    x = np.random.default_rng(1).uniform(-1, 1, (1, 56, 84, 3)).astype(np.float32)
    jm = JDepthAnythingV2(size="vits", max_depth=20.0)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    metric = DepthAnythingV2("vits", max_depth=20.0).eval()
    metric.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = metric(_nchw(x)).numpy()
    assert got.shape == (1, 56, 84)
    assert 0.0 <= got.min() and got.max() <= 20.0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_state_dict_round_trip_through_jax_import_map(da2):
    """port state_dict -> import_state_dict(map_depth_anything_key) ->
    state_dict_from_flax gives back every live tensor exactly; only the dead
    keys are unmapped."""
    _, params, _, _ = da2
    model = init_weights_(DepthAnythingV2("vits"), torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jparams, _, report = import_state_dict(sd, params, {}, map_depth_anything_key)
    assert not report["shape_mismatch"]
    assert sorted(report["unmapped"]) == sorted(k for k in sd if _dead(k))
    back = state_dict_from_flax(jparams, {}, "DepthAnythingV2")
    live = {k for k in sd if not _dead(k)}
    assert set(back) == live
    for k in live:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


@pytest.mark.parametrize("size", ["vits", "vitb", "vitl"])
def test_factory_builds_every_size(size):
    """``DepthAnythingV2_{size}`` builds the JAX module's parameters plus the
    release grammar's dead ones (mask_token, refinenet4.resConfUnit1)."""
    cfg = config.defaults()
    cfg.model.model_type = f"DepthAnythingV2_{size}"
    model = build_model(cfg.model, "cpu", torch.Generator().manual_seed(0))
    assert isinstance(model, DepthAnythingV2) and model.pretrained.blocks[0].attn.num_heads == {
        "vits": 6, "vitb": 12, "vitl": 16}[size]
    shapes = jax.eval_shape(lambda: JDepthAnythingV2(size=size).init(
        jax.random.key(0), jnp.zeros((1, 28, 28, 3))))["params"]
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    n_dead = sum(v.numel() for k, v in model.state_dict().items() if _dead(k))
    assert sum(p.numel() for p in model.parameters()) == n_jax + n_dead
    assert all(torch.isfinite(p).all() for p in model.parameters())

"""Every branch of the model factory in the port against the JAX package's,
at float32 on the CPU, at small geometry (64x96 inputs).

For each model: MiDaS-small, MiDaS-small with LocalBins and DGR, the flagship
with LocalBins (and its dead DGR blocks), U-Net, MidasNet (ResNeXt101 blocks,
encoder (1, 1, 1, 1)), DPT_Large (vitl16_384 narrowed to 64 wide at its 24
blocks, in both packages) and DPT_Hybrid (full width):
- the forward against the JAX module, its weights (BN statistics randomised,
  the final depth bias raised by 0.5 so the last ReLU passes most of the map)
  carried by ``state_dict_from_flax``;
- the state_dict's keys and shapes equal to the reference grammar's built by
  tests/torch_*_ref.py (where one exists; DPT_Hybrid's is held to the JAX
  map alone);
- a round trip: the port's state_dict through ``import_state_dict`` with the
  JAX map fills every JAX leaf, leaves only the model's dead keys (and BN's
  counters) unmapped, gives back each tensor exactly through
  ``state_dict_from_flax``, and the JAX forward on it equals the port's.
Then ``count_params`` and the evaluation tool's trainable count against
mde_tpu's for a use_dgr flagship and for DPT_Hybrid. The factory, a train
step and the server: tests/test_torch_zoo_train.py.

Tolerance: rtol 1e-4, atol 1e-5, and corrcoef > 0.9999: float32 through 20-40
layers, LocalBins' attractors and softmax. The largest gaps measured are
1.1e-6 (the flagship with LocalBins) and 9.5e-7 (U-Net, depths up to 6);
DPT_Hybrid's is 2.4e-5 on depths up to 1.6, through flax's GroupNorm, so its
atol is 5e-5 of the map's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.models.dpt import DPTDepthModel as JDPT
from mde_tpu.models.midas_net import MidasNet as JMidasNet
from mde_tpu.models.midas_semantics import MidasNetSemantics as JSemantics
from mde_tpu.models.midas_small import MidasNetSmall as JMidasSmall
from mde_tpu.models.simple_unet import SimpleUNet as JUNet
from mde_tpu.nn import vit as jvit
from mde_tpu.tools import evaluation as jax_evaluation
from mde_tpu.train import torch_import as ti
from mde_tpu.utils import count_params as jax_count_params
from mde_tpu_torch.models.dpt import DPTDepthModel
from mde_tpu_torch.models.midas_net import MidasNet
from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
from mde_tpu_torch.models.midas_small import MidasNetSmall
from mde_tpu_torch.models.simple_unet import SimpleUNet
from mde_tpu_torch.nn import vit
from mde_tpu_torch.nn.blocks import init_weights_
from mde_tpu_torch.tools import evaluation
from mde_tpu_torch.train.checkpoint import load_state_dict
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.utils import count_params
from tests.test_torch_import import TorchSimpleUNet
from tests.test_torch_modules import _nchw, _randomize
from tests.torch_dpt_ref import DPTTorch
from tests.torch_flagship_ref import MidasNetSemanticsTorch
from tests.torch_localbins_ref import DGRTorch, LocalBinsBlockTorch, MidasNetSmallTorch
from tests.torch_midas_net_ref import MidasNetTorch

torch.set_num_threads(2)

SIZE = (64, 96)
NARROW_VITL = (64, 24, 4, 16)  # vitl16_384 at its depth and hooks, 64 wide, 4 heads
DINO_SIZE = (28, 42)


def _flagship_ref():
    ref = MidasNetSemanticsTorch(dinov2_image_size=DINO_SIZE)
    ref.local_bins = LocalBinsBlockTorch()
    for i in range(4):
        ref.add_module(f"dgr{i + 1}", DGRTorch(64 * 2**i))
    return ref


# name -> (JAX module, port module, convert rules, JAX key map, reference
# grammar builder or None, flax path of the final depth conv's bias)
CASES = {
    "midas_small": (lambda: JMidasSmall(), lambda: MidasNetSmall(), "MidasNetSmall",
                    ti.map_midas_small_key, lambda: MidasNetSmallTorch(),
                    ("output_conv4", "Conv_0", "bias")),
    "midas_small_lb_dgr": (lambda: JMidasSmall(use_lb=True, use_dgr=True),
                           lambda: MidasNetSmall(use_lb=True, use_dgr=True), "MidasNetSmall",
                           ti.map_midas_small_key,
                           lambda: MidasNetSmallTorch(use_lb=True, use_dgr=True),
                           ("output_conv4", "Conv_0", "bias")),
    "flagship_lb": (lambda: JSemantics(use_lb=True, use_dgr=True, dinov2_image_size=DINO_SIZE),
                    lambda: MidasNetSemantics(use_lb=True, use_dgr=True,
                                              dinov2_image_size=DINO_SIZE),
                    "MidasNetSemantics", ti.map_midas_semantics_key, _flagship_ref,
                    ("depth_head_1", "Conv_0", "bias")),
    "unet": (lambda: JUNet(), lambda: SimpleUNet(), "SimpleUNet", ti.map_simple_unet_key,
             lambda: TorchSimpleUNet(), ("final", "Conv_0", "bias")),
    "midas": (lambda: JMidasNet(encoder_layers=(1, 1, 1, 1)),
              lambda: MidasNet(encoder_layers=(1, 1, 1, 1)), "MidasNet", ti.map_midas_net_key,
              lambda: MidasNetTorch(layers=(1, 1, 1, 1)), ("output_conv4", "Conv_0", "bias")),
    "dpt_large": (lambda: JDPT(backbone="vitl16_384"), lambda: DPTDepthModel("vitl16_384"),
                  "DPTDepthModel", ti.map_dpt_key,
                  lambda: DPTTorch(256, *NARROW_VITL[:3], hooks=(5, 11, 17, 23),
                                   out_channels=(256, 512, 1024, 1024)),
                  ("head_conv4", "Conv_0", "bias")),
    "dpt_hybrid": (lambda: JDPT(backbone="vitb_rn50_384"), lambda: DPTDepthModel("vitb_rn50_384"),
                   "DPTDepthModel", lambda k: ti.map_dpt_key(k, hybrid=True), None,
                   ("head_conv4", "Conv_0", "bias")),
}


@pytest.fixture(autouse=True)
def narrow_vitl(monkeypatch):
    monkeypatch.setitem(jvit.VIT_CONFIGS, "vitl16_384", NARROW_VITL)
    monkeypatch.setitem(vit.VIT_CONFIGS, "vitl16_384", NARROW_VITL)


_BUILT = {}


def built(name):
    """(jax module, params, stats, port with the JAX weights, jitted JAX
    forward) of a case, once."""
    if name not in _BUILT:
        jfn, pfn, rules, _, _, bias = CASES[name]
        jm = jfn()
        variables = jax.jit(lambda k: jm.init(k, jnp.zeros((1, *SIZE, 3))))(jax.random.key(0))
        rng = np.random.default_rng(0)
        params = _randomize(variables["params"], rng)
        stats = _randomize(variables.get("batch_stats", {}), rng)
        leaf = params
        for k in bias[:-1]:
            leaf = leaf[k]
        leaf[bias[-1]] += 0.5
        port = init_weights_(pfn(), torch.Generator().manual_seed(0)).eval()
        report = load_state_dict(port, state_dict_from_flax(params, stats, rules))
        assert not report["unexpected"] and not report["shape_mismatch"], report
        unset = [k for k in report["missing"] if not k.endswith("num_batches_tracked")
                 and not k.startswith(port.DEAD_KEY_PREFIXES)]
        assert not unset, unset
        _BUILT[name] = jm, params, stats, port, jax.jit(
            lambda p, s, a: jm.apply({"params": p, "batch_stats": s}, a))
    return _BUILT[name]


def _x(seed=1, b=2):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (b, *SIZE, 3)).astype(np.float32)


def _atol(name, want):
    """1e-5; DPT_Hybrid's 5e-5 of the map's largest value: flax's GroupNorm
    takes the variance as E[x^2] - E[x]^2 (tests/test_torch_zoo.py's stem)."""
    return 5e-5 * float(np.abs(want).max()) if name == "dpt_hybrid" else 1e-5


def _dead(model, key):
    return key.startswith(model.DEAD_KEY_PREFIXES) or key.endswith("num_batches_tracked")


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    _, params, stats, port, japply = built(name)
    x = _x()
    want = np.asarray(japply(params, stats, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
        plain = port(_nchw(x), plain=True).numpy()
    assert got.shape == want.shape == (2, *SIZE)
    assert float(want.std()) > 1e-3 and (want > 0).mean() > 0.5  # not clipped to a constant
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=_atol(name, want))
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    np.testing.assert_array_equal(plain, got)  # on the CPU both routes are the plain version


@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n][4] is not None))
def test_state_dict_is_the_reference_grammar(name):
    """Keys and shapes of the reference build, dead keys included."""
    _, pfn, _, _, ref_fn, _ = CASES[name]
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in ref_fn().state_dict().items()}
        got = {k: tuple(v.shape) for k, v in pfn().state_dict().items()}
    assert got == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_through_the_jax_map(name):
    _, params, stats, _, japply = built(name)
    _, pfn, rules, key_map, _, _ = CASES[name]
    model = init_weights_(pfn(), torch.Generator().manual_seed(3)).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jparams, jstats, report = ti.import_state_dict(sd, params, stats, key_map)
    assert not report["shape_mismatch"], report["shape_mismatch"][:5]
    assert sorted(report["unmapped"]) == sorted(k for k in sd if _dead(model, k))
    n_leaves = len(jax.tree_util.tree_leaves(params)) + len(jax.tree_util.tree_leaves(stats))
    assert report["loaded"] == n_leaves  # every JAX leaf, once
    back = state_dict_from_flax(jparams, jstats, rules)
    live = {k for k in sd if not _dead(model, k)}
    assert set(back) == live
    for k in live:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    x = _x(seed=2)
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    want = np.asarray(japply(jparams, jstats, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=_atol(name, want))


@pytest.mark.parametrize("name", ["flagship_lb", "dpt_hybrid"])
def test_dead_keys_and_counts_match_jax(name):
    """``count_params`` and the evaluation tool's trainable count against
    mde_tpu's for a use_dgr semantics model and for DPT: the dead keys (DGR
    blocks, refinenet4's first RCU, the trunk's final norm) are what the port
    holds beyond the JAX tree; DGR's taps and LocalBins' buffers are no
    parameters."""
    _, params, stats, port, _ = built(name)
    dead = sum(p.numel() for k, p in port.named_parameters() if _dead(port, k))
    assert dead > 0
    assert count_params(port) == jax_count_params(params) + dead
    assert count_params(state_dict_from_flax(params, None, CASES[name][2])) == \
        jax_count_params(params)
    assert evaluation.count_trainable_params(port) == \
        jax_evaluation.count_trainable_params(params)
    assert not any(".lap" in k or "log_binomial_transform" in k for k, _ in port.named_parameters())

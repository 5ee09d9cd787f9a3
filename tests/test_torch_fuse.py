"""The port's conv+BN folding (nn/fuse.py) against mde_tpu's (mde_tpu/nn/fuse.py)
on the flagship of tests/test_torch_slice.py (its BN statistics and weights
randomised), on the CPU.

- Pairs: the port's, found in the reference grammar, are mde_tpu's pairs with
  each flax module path named as train/convert.py names it.
- Folded weights: the port's ``fuse_model_params`` on the carried-over
  state_dict against mde_tpu's ``fuse_model_params`` carried over, rtol 0,
  atol 1e-6: both fold in float64 and round once to float32 (the kernels'
  layouts differ, so a product may round the other way: an ulp of weights
  below 8).
- The fused model in eval mode against the unfused one on the same input:
  rtol 1e-5, atol 1e-5, float32 rounding of the folded products through the
  network (mde_tpu's own test holds its fold at atol 1e-5).
"""

import copy

import numpy as np
import torch

from mde_tpu.nn import fuse as jax_fuse
from mde_tpu_torch.nn import fuse
from mde_tpu_torch.train.checkpoint import load_state_dict
from mde_tpu_torch.train.convert import MODEL_RULES, _module_key, state_dict_from_flax
from tests.test_torch_slice import flagship  # noqa: F401

torch.set_num_threads(2)


def _port_name(path) -> str:
    return _module_key(MODEL_RULES["MidasNetSemantics"], "/".join(path))


def test_pairs_match_mde_tpu(flagship):  # noqa: F811
    _, params, stats, port, _ = flagship
    want = sorted((_port_name(c), _port_name(b))
                  for c, b in jax_fuse.discover_conv_bn_pairs(params, stats))
    got = fuse.discover_conv_bn_pairs(port.state_dict())
    assert got == want
    assert len(got) > 50 and ("pretrained.layer1.0", "pretrained.layer1.1") in got
    assert ("cross_attention.spatial_upsample.3", "cross_attention.spatial_upsample.4") in got


def test_folded_weights_match_mde_tpu(flagship):  # noqa: F811
    _, params, stats, _, _ = flagship
    want = state_dict_from_flax(*jax_fuse.fuse_model_params(params, stats))
    got = fuse.fuse_model_params(state_dict_from_flax(params, stats))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    # every folded BN is the exact identity but for its bias
    for _, bn in fuse.discover_conv_bn_pairs(got):
        eps = 1e-3 if bn.startswith("pretrained.") else 1e-5
        assert torch.equal(got[f"{bn}.weight"], torch.ones_like(got[f"{bn}.weight"]))
        assert not got[f"{bn}.running_mean"].any()
        assert torch.equal(got[f"{bn}.running_var"],
                           torch.full_like(got[f"{bn}.running_var"], 1.0 - eps))


def test_fused_model_matches_unfused(flagship):  # noqa: F811
    port = flagship[3].eval()
    fused = copy.deepcopy(port)
    load_state_dict(fused, fuse.fuse_model_params(port.state_dict()))
    x = torch.from_numpy(np.random.default_rng(4).uniform(-1.5, 1.5, (2, 3, 64, 96))
                         .astype(np.float32))
    with torch.no_grad():
        want = port(x)
        got = fused(x)
    assert float(want.std()) > 1e-3
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    changed = [k for k, v in fused.state_dict().items() if not torch.equal(v, port.state_dict()[k])]
    assert any(k.endswith("running_var") for k in changed)

"""Checks shared by tests/test_torch_export_zoo.py and
tests/test_torch_export_loader.py: one archive a model at buckets (1, 2) on
the CPU (train/export.py), held against the port's live predict step, the
JAX package's predict step, its graphs and its weights.

- Exported predictor against the port's live ``make_predict_step``: rtol 0,
  atol 1e-6, tests/test_torch_export.py's bound (the same float32 operations;
  export may write a composite operation out in its parts).
- Against mde_tpu's ``make_predict_step`` on the same weights: the bound of
  the model's own forward test against JAX (tests/test_torch_zoo_models.py,
  tests/test_torch_dpt_trunks.py), passed in by the caller.
- Each bucket's graph: the ``mde_tpu`` op nodes the caller names, and of the
  plain versions' signature operations (K1's and K4's softmax, K1's amax,
  K3's ``index_select``) only the model's own softmaxes.
- ``weights.pt``: every tensor of the state_dict with its dtype and bits, and
  every key an input of each program (``functional_call`` sees them all).
"""

import collections
import io
import zipfile

import jax.numpy as jnp
import numpy as np
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.train.trainer import TrainState, make_predict_step as jax_predict_step
from mde_tpu_torch.core import config
from mde_tpu_torch.ops import kernels as K
from mde_tpu_torch.train import export as E
from mde_tpu_torch.train.trainer import make_predict_step

BUCKETS = (1, 2)
NATIVE = (60, 80)
# aten ops that only a plain version of K1, K3 or K4 would write into a graph
# of these models, beyond the model's own softmaxes
PLAIN_SIGNATURE = ("softmax", "amax", "index_select")


def geometry(input_size) -> dict:
    return {"framework": {"input_size": list(input_size), "native_size": list(NATIVE)}}


class Archive:
    """One model's archive at BUCKETS: the port model, its cfg, the path, the
    bundle and one predictor over it (each bucket's program deserialised
    once, on first use, and shared by the checks)."""

    def __init__(self, port, input_size, path):
        self.port, self.path, self.input_size = port, path, tuple(input_size)
        self.cfg = config.from_dict(geometry(input_size))
        self.bundle = E.export_predict(port, self.cfg, BUCKETS, platforms=["cpu"])
        E.save_exported(str(path), self.bundle)
        self.predictor = E.load_exported(str(path), "cpu")

    def graph(self, b: int):
        return self.predictor._call_for(b)


def batch(seed: int, b: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, *NATIVE, 3), dtype=np.uint8)


def check_live(a: Archive) -> None:
    assert a.predictor.batch_sizes == list(BUCKETS)
    for b in BUCKETS:
        u8 = batch(b, b)
        got = a.predictor.predict(u8)
        want = make_predict_step(a.port, a.cfg)(torch.from_numpy(u8)).numpy()
        assert got.shape == (b, *NATIVE) and got.dtype == np.float32
        assert (want > 0).mean() > 0.5 and float(want.std()) > 0  # off the final ReLU
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def check_jax(a: Archive, jm, params, stats, rtol, atol) -> None:
    """Bucket 2 against mde_tpu's predict step; ``atol(want)`` is the bound."""
    state = TrainState(step=jnp.asarray(0), params=params, batch_stats=stats, opt_state=(),
                       tx=None)
    u8 = batch(7, 2)
    want = np.asarray(jax_predict_step(jm, jax_config.from_dict(geometry(a.input_size)))(
        state, jnp.asarray(u8)))
    got = a.predictor.predict(u8)
    assert (want > 0).mean() > 0.5 and float(want.std()) > 1e-4
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol(want))
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def graph_counts(a: Archive, b: int) -> tuple[dict, dict]:
    """({mde_tpu op: nodes}, {plain signature: nodes}) of bucket ``b``'s graph."""
    ops, plain = collections.Counter(), collections.Counter()
    for node in a.graph(b).graph.nodes:
        t = node.target
        if node.op != "call_function" or not isinstance(t, torch._ops.OpOverload):
            continue
        assert t.namespace in ("aten", K.OPS_NAMESPACE), t
        if t.namespace == K.OPS_NAMESPACE:
            ops[t._opname] += 1
        for sig in PLAIN_SIGNATURE:
            if sig in t._opname:
                plain[sig] += 1
    return dict(ops), dict(plain)


def check_graphs(a: Archive, want_ops: dict, own_softmax: int) -> None:
    for b in BUCKETS:
        ops, plain = graph_counts(a, b)
        assert ops == want_ops, (b, ops)
        assert plain == ({"softmax": own_softmax} if own_softmax else {}), (b, plain)


def check_weights(a: Archive, buffers: dict) -> None:
    """weights.pt holds the state_dict bit for bit with its dtypes, with each
    of ``buffers`` ({key suffix: dtype}) present; each program takes every
    key as an input; a second predictor loaded from the archive gives the
    first one's bits."""
    with zipfile.ZipFile(a.path) as zf:
        stored = torch.load(io.BytesIO(zf.read(E.WEIGHTS_NAME)), weights_only=True)
    state = a.port.state_dict()
    assert list(stored) == list(state)
    for k, v in state.items():
        assert stored[k].dtype == v.dtype and torch.equal(stored[k], v), k
    for suffix, dtype in buffers.items():
        hits = [k for k in stored if k.endswith(suffix)]
        assert hits and all(stored[k].dtype == dtype for k in hits), (suffix, hits)
    for b in BUCKETS:
        assert a.graph(b)._in_spec.child(0).child(0).context == list(state)
    u8 = batch(3, 2)
    again = E.load_exported(str(a.path), "cpu").predict(u8)
    np.testing.assert_array_equal(again, a.predictor.predict(u8))


def check_warmup(a: Archive) -> None:
    """``warmup()`` of a fresh predictor runs each bucket once, on zeros of
    its shape."""
    predictor = E.load_exported(str(a.path), "cpu")
    seen = []
    run = predictor.predict_tensor
    predictor.predict_tensor = lambda x: seen.append(tuple(x.shape)) or run(x)
    predictor.warmup()
    assert seen == [(b, *NATIVE, 3) for b in BUCKETS]
    assert sorted(predictor._calls) == list(BUCKETS)

"""The port's evaluation tool and prediction dump over a (2, 2) world, on the
CPU over gloo.

The flagship of tests/test_torch_slice.py (64x96, DINOv2 at 28x42, weights
from a seed carried to the port by ``state_dict_from_flax``) is saved as a
checkpoint; a generated dataset of 5 train and 3 test images (60x80) is read
at batch 2, so that each tool meets batches that split over the two data
indices and a last batch of one that does not (it runs whole). Each tool
runs three ways on the same files:

- the world: ``python -m tests.torch_world_tool <tool>`` (the port's CLI
  with the model at that DINOv2 size in every rank) at
  ``framework.mesh.data=2``, ``framework.mesh.model=2``, which starts its
  four ranks;
- one process: the tool's ``main`` in this process (``common.build_model``
  patched the same way);
- mde_tpu over ``make_mesh(2, 2)``: ``evaluate`` and
  ``generate_test_predictions`` with the parameters laid out by
  ``shard_params_tp``.

Evaluation: rank 0 alone prints; its metrics equal one process's within
1e-6 relative, SI-RMSE within 5e-6 (``TOL_METRICS``: float32 predictions
whose Megatron sums run in another order, then batch means in float64), and
mde_tpu's within
tests/test_torch_tools.py's bounds (rtol 2e-3, atol 2e-4: the port against
JAX). Predictions: the same ``.npy`` names; each map within 1e-6 of one
process's map's largest absolute value and within the JAX bounds of
mde_tpu's; each CSV row decodes to its ``.npy`` rounded to two decimals,
and the world's rows to one process's within 0.01 (a value within 1e-6 of a
rounding boundary may round the other way).
"""

import base64
import csv
import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.data.dataset import DepthDataset as JDepthDataset
from mde_tpu.data.loader import HostLoader as JHostLoader
from mde_tpu.parallel import active_mesh, make_mesh, replicate, shard_params_tp
from mde_tpu.train import trainer as jax_trainer
from mde_tpu_torch.data import synthetic
from mde_tpu_torch.tools import common, evaluation, generate_predictions
from mde_tpu_torch.train.checkpoint import checkpoint_path, save_checkpoint
from tests.test_torch_slice import flagship  # noqa: F401  (module fixture)
from tests.torch_world_tool import build_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_NAME = "tools_world"
# relative, the world against one process; SI-RMSE is the square root of a
# variance (a difference of means), whose cancellation amplifies the maps'
# differences of about 2e-7 (read 6.7e-7 here, the other metrics at most 5e-8)
TOL_METRICS = {"si_rmse": 5e-6, "abs_rel": 1e-6, "delta_1": 1e-6, "delta_2": 1e-6,
               "delta_3": 1e-6}
TOL_MAPS = 1e-6  # of the map's largest absolute value, the world against one process
RTOL_JAX, ATOL_JAX = 2e-3, 2e-4  # tests/test_torch_tools.py's port-against-JAX bounds
LABELS = {"si_rmse": "Average Scale-Invariant Loss", "abs_rel": "Average Absolute Relative Error",
          "delta_1": "Average Delta 1.05 Threshold", "delta_2": "Average Delta 1.1025 Threshold",
          "delta_3": "Average Delta 1.1576250000000001 Threshold"}


@pytest.fixture(scope="module")
def env(flagship, tmp_path_factory):  # noqa: F811
    """Data, one YAML config for both packages, the port's checkpoint, and
    mde_tpu's model and state over make_mesh(2, 2)."""
    jm, params, stats, port, _ = flagship
    root = tmp_path_factory.mktemp("tools_world")
    synthetic.generate(str(root / "data"), n_train=5, n_test=3, size=(60, 80), seed=3)
    cfg_path = root / "config.yaml"
    cfg_path.write_text(f"""
paths:
  data_dir: {root / 'data'}
  results_dir: {root / 'results'}
experiment:
  model_name: {MODEL_NAME}
  wandb_disable: true
training:
  batch_size: 2
framework:
  input_size: [64, 96]
  native_size: [60, 80]
  num_workers: 2
  eval_n_samples: 5
""")
    save_checkpoint(checkpoint_path(str(root / "results"), MODEL_NAME), port)
    jmesh = make_mesh(2, 2)
    state = jax_trainer.TrainState(step=jnp.asarray(0), params=shard_params_tp(params, jmesh),
                                   batch_stats=replicate(stats, jmesh), opt_state=(), tx=None)
    return root, cfg_path, jm, state, jmesh


def _argv(root, cfg_path, predictions: str):
    return ["--config", str(cfg_path), "--device", "cpu",
            "--set", f"paths.predictions_dir={root / predictions}"]


def _world(tool: str, argv: list, cwd) -> str:
    """The tool over (2, 2), started as a user starts it; its output."""
    proc = subprocess.run(
        [sys.executable, "-m", "tests.torch_world_tool", tool, *argv,
         "--set", "framework.mesh.data=2", "--set", "framework.mesh.model=2"],
        cwd=cwd, env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Starting 4 processes: (data, model) = (2, 2)" in proc.stdout
    return proc.stdout


def test_evaluation_tool_over_the_world(env, monkeypatch, capsys):
    root, cfg_path, jm, state, jmesh = env
    out = _world("evaluation", _argv(root, cfg_path, "unused"), root)
    monkeypatch.setattr(common, "build_model", build_model)
    one = evaluation.main(_argv(root, cfg_path, "unused"))
    one_out = capsys.readouterr().out

    printed = [line.rsplit(": ", 1) for line in out.splitlines()
               if ": " in line and not line.startswith("Starting")]
    got = {label: float(value) for label, value in printed if label in LABELS.values()}
    assert [label for label, _ in printed] == [
        label for label, _ in (line.rsplit(": ", 1) for line in one_out.splitlines()
                               if ": " in line)]  # rank 0 alone printed, each line once
    assert dict(printed)["Number of trainable parameters in the model"] == str(
        evaluation.count_trainable_params(env_model(root, cfg_path)))  # the whole model's
    jcfg = jax_config.load(str(cfg_path))
    loader = JHostLoader(JDepthDataset(str(root / "data" / "train"),
                                       str(root / "data" / "train_list.txt"), has_gt=True),
                         batch_size=2, shuffle=False, num_workers=2)
    with active_mesh(None):  # the windowed attention's XLA form, as the TP tests
        want = jax_trainer.evaluate(jm, jcfg, state, loader, mesh=jmesh, n_samples=5)
    for key, label in LABELS.items():
        assert got[label] == pytest.approx(one[key], rel=TOL_METRICS[key], abs=0), key
        np.testing.assert_allclose(got[label], float(want[key]), rtol=RTOL_JAX, atol=ATOL_JAX,
                                   err_msg=key)


def env_model(root, cfg_path):
    """The checkpoint's model in one process (``common.build_model`` patched
    by the caller)."""
    cfg, _ = common.parse_config("test", argv=["--config", str(cfg_path)])
    return common.bootstrap_model(cfg, "cpu", checkpoint_path(str(root / "results"), MODEL_NAME))[0]


def _decoded(path) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return {row[0]: np.array([float(v) for v in zlib.decompress(
        base64.b64decode(row[1])).decode().split(",")]) for row in rows}


def test_prediction_dump_over_the_world(env, monkeypatch):
    root, cfg_path, jm, state, jmesh = env
    for name in ("cwd_world", "cwd_one"):
        (root / name).mkdir(exist_ok=True)
    out = _world("generate_predictions", _argv(root, cfg_path, "pred_world"), root / "cwd_world")
    assert out.count("CSV file saved to: predictions.csv") == 1  # rank 0 alone encodes
    monkeypatch.setattr(common, "build_model", build_model)
    monkeypatch.chdir(root / "cwd_one")
    assert generate_predictions.main(_argv(root, cfg_path, "pred_one")) == 3
    jcfg = jax_config.load(str(cfg_path))
    loader = JHostLoader(JDepthDataset(str(root / "data" / "test"),
                                       str(root / "data" / "test_list.txt"), has_gt=False),
                         batch_size=2, num_workers=2)
    with active_mesh(None):
        jax_trainer.generate_test_predictions(jm, jcfg, state, loader, str(root / "pred_jax"),
                                              mesh=jmesh)

    names = sorted(os.listdir(root / "pred_world"))
    assert names == sorted(os.listdir(root / "pred_one")) == sorted(
        os.listdir(root / "pred_jax")) == [f"test_{i:06d}_depth.npy" for i in range(3)]
    for name in names:
        got, one = np.load(root / "pred_world" / name), np.load(root / "pred_one" / name)
        assert got.shape == one.shape == (60, 80) and got.dtype == np.float32
        assert np.abs(got - one).max() <= TOL_MAPS * np.abs(one).max(), name
        np.testing.assert_allclose(got, np.load(root / "pred_jax" / name), rtol=RTOL_JAX,
                                   atol=ATOL_JAX, err_msg=name)
    world_rows = _decoded(root / "cwd_world" / "predictions.csv")
    one_rows = _decoded(root / "cwd_one" / "predictions.csv")
    assert list(world_rows) == list(one_rows) == [n[:-4] for n in names]
    for key, values in world_rows.items():
        own = np.load(root / "pred_world" / f"{key}.npy").ravel()
        assert np.array_equal(values, np.array([float(f"{x:.2f}") for x in np.round(own, 2)]))
        assert np.abs(values - one_rows[key]).max() <= 0.01 + 1e-6, key

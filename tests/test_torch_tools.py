"""The port's evaluation, prediction, CSV and visualisation tools against
mde_tpu's, on the CPU.

The flagship of tests/test_torch_slice.py (64x96, DINOv2 at 28x42, BN
statistics and LayerScale gammas randomised, weights carried by
``state_dict_from_flax``) is the model of both packages' tools: the JAX
tools get it through their ``bootstrap_model``, the port's tools load it
from a ``.pth`` checkpoint into a model built at that DINOv2 size. Both read
one generated dataset (60x80 images) and one YAML config.

- ``process_depth_maps``: the same bytes as mde_tpu's (pandas) on the same
  ``.npy`` files, negative values, values on a .xx5 boundary and -0.0
  among them, and the same two printed lines.
- The evaluation tool: the same printed lines in the same order, the
  parameter count exactly and the metrics at rtol 2e-3, atol 2e-4 (the
  bounds of tests/test_torch_fit.py::test_eval_and_metric_steps_match_jax).
- The prediction tool: the same ``.npy`` names and values within those
  bounds, and the same CSV ids.
- Visualisation: the prediction and ground truth within those bounds, the
  loss map at rtol 2e-3, atol 2e-3 (the square of a log difference: a
  relative error e of the prediction moves it by about 2 |d| e), and the
  JAX tool's PNG names.
- ``count_params`` against ``mde_tpu.utils.count_params``.
- Each tool refuses ``--device cuda`` without a card, and turns TF32 off
  and cuDNN's deterministic algorithms on before it reads its paths;
  ``bootstrap_model`` takes no default device. Every test puts the three
  flags back as it found them.
"""

import csv
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.tools import create_prediction_csv as jax_csv
from mde_tpu.tools import evaluation as jax_evaluation
from mde_tpu.tools import generate_predictions as jax_predictions
from mde_tpu.tools import visualize as jax_visualize
from mde_tpu.train.trainer import TrainState
from mde_tpu.utils import count_params as jax_count_params
from mde_tpu_torch.data import synthetic
from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
from mde_tpu_torch.nn.blocks import init_weights_
from mde_tpu_torch.tools import common, create_prediction_csv, evaluation, generate_predictions
from mde_tpu_torch.tools import visualize
from mde_tpu_torch.train.checkpoint import checkpoint_path, save_checkpoint
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.utils import count_params, ensure_dir
from tests.test_torch_slice import DINO, flagship  # noqa: F401  (module fixture)

torch.set_num_threads(2)
RTOL, ATOL = 2e-3, 2e-4
MODEL_NAME = "tools_flagship"


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = _flags()
    yield
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


# ---------------------------------------------------------------------------
# The CSV encoder
# ---------------------------------------------------------------------------

CSV_CASES = {
    "boundaries": [
        np.array([[-0.0, 0.0, 0.005, 0.015], [0.125, 2.675, -1.005, -0.004]], np.float32),
        np.array([[1.115, 9.995, -3.335], [12.345, 0.5, 100.0]], np.float64),
        np.random.default_rng(0).uniform(-5, 90, (6, 7)).astype(np.float32),
    ],
    "one_map": [np.random.default_rng(1).uniform(0, 10, (12, 16)).astype(np.float32)],
    "empty_list": [],
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_prediction_csv_is_byte_identical_to_jax(tmp_path, capsys, case):
    pred_dir = tmp_path / "predictions"
    pred_dir.mkdir()
    lines = []
    for i, arr in enumerate(CSV_CASES[case]):
        np.save(pred_dir / f"test_{i:06d}_depth.npy", arr)
        lines.append(f"test_{i:06d}_rgb.png test_{i:06d}_depth.npy")
    test_list = tmp_path / "test_list.txt"
    test_list.write_text("".join(line + "\n" for line in lines))
    outputs = {}
    for name, tool in (("jax", jax_csv), ("port", create_prediction_csv)):
        out = tmp_path / f"{name}.csv"
        tool.process_depth_maps(str(pred_dir), str(test_list), str(out))
        outputs[name] = (out.read_bytes(), capsys.readouterr().out.replace(str(out), "OUT"))
    assert outputs["port"] == outputs["jax"]
    assert outputs["port"][0].startswith(b"id,Depths\n") and b"\r" not in outputs["port"][0]
    assert f"Shape of the CSV: ({len(lines)}, 2)" in outputs["port"][1]


def test_prediction_csv_cli_takes_the_jax_flags(tmp_path, monkeypatch):
    np.save(tmp_path / "a.npy", np.ones((2, 2), np.float32))
    (tmp_path / "list.txt").write_text("a.png a.npy\n")
    monkeypatch.chdir(tmp_path)
    create_prediction_csv.main(["--predictions-dir", ".", "--test-list", "list.txt",
                                "--output", "port.csv"])
    monkeypatch.setattr(sys, "argv", ["create_prediction_csv.py", "--predictions-dir", ".",
                                      "--test-list", "list.txt", "--output", "jax.csv"])
    jax_csv.main()
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


# ---------------------------------------------------------------------------
# The tools on the flagship
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env(flagship, tmp_path_factory):  # noqa: F811
    """Data, one YAML config for both packages, the port's checkpoint."""
    _, _, _, port, _ = flagship
    root = tmp_path_factory.mktemp("tools")
    synthetic.generate(str(root / "data"), n_train=5, n_test=3, size=(60, 80), seed=3)
    cfg_path = root / "config.yaml"
    cfg_path.write_text(f"""
paths:
  data_dir: {root / 'data'}
  results_dir: {root / 'results_jax'}
  predictions_dir: {root / 'predictions_jax'}
experiment:
  model_name: {MODEL_NAME}
  wandb_disable: true
training:
  batch_size: 2
framework:
  input_size: [64, 96]
  native_size: [60, 80]
  num_workers: 2
  eval_n_samples: 3
  mesh: {{data: -1, model: 1}}
""")
    save_checkpoint(checkpoint_path(str(root / "results_port"), MODEL_NAME), port)
    return root, cfg_path


def _port_argv(root, cfg_path, *extra):
    return ["--config", str(cfg_path), "--device", "cpu",
            "--set", f"paths.results_dir={root / 'results_port'}",
            "--set", f"paths.predictions_dir={root / 'predictions_port'}", *extra]


@pytest.fixture
def patched(flagship, monkeypatch):  # noqa: F811
    """mde_tpu's tools take the fixture's model and weights; the port's build
    the flagship at the fixture's DINOv2 size (its weights come from the
    checkpoint)."""
    jm, params, stats, _, _ = flagship
    state = TrainState(step=jnp.asarray(0), params=params, batch_stats=stats, opt_state=(),
                       tx=None)
    for tool in (jax_evaluation, jax_predictions, jax_visualize):
        monkeypatch.setattr(tool, "bootstrap_model",
                            lambda cfg, mesh=None, checkpoint=None: (jm, state, None))

    def build_model(model_cfg, device, generator):
        return init_weights_(MidasNetSemantics(dinov2_image_size=DINO), generator).to(device)

    monkeypatch.setattr(common, "build_model", build_model)


def _jax_main(monkeypatch, tool, *argv):
    monkeypatch.setattr(sys, "argv", [tool.__name__, *argv])
    tool.main()


def _printed(text):
    """(label, value) of each 'label: value' line."""
    return [tuple(line.rsplit(": ", 1)) for line in text.splitlines() if ": " in line]


def test_evaluation_tool_matches_jax(env, patched, monkeypatch, capsys):
    root, cfg_path = env
    _jax_main(monkeypatch, jax_evaluation, "--config", str(cfg_path))
    want_out = capsys.readouterr().out
    metrics = evaluation.main(_port_argv(root, cfg_path))
    got_out = capsys.readouterr().out
    for out, results in ((got_out, "results_port"), (want_out, "results_jax")):
        ckpt = checkpoint_path(str(root / results), MODEL_NAME)
        assert out.splitlines()[0] == f"Loading model MiDaS_small from {ckpt}"
    got, want = _printed(got_out), _printed(want_out)
    assert [label for label, _ in got] == [label for label, _ in want] == [
        "Number of trainable parameters in the model", "Average Scale-Invariant Loss",
        "Average Absolute Relative Error", "Average Delta 1.05 Threshold",
        "Average Delta 1.1025 Threshold", "Average Delta 1.1576250000000001 Threshold"]
    assert got[0][1] == want[0][1]
    np.testing.assert_allclose([float(v) for _, v in got[1:]], [float(v) for _, v in want[1:]],
                               rtol=RTOL, atol=ATOL)
    assert [float(v) for _, v in got[1:]] == [
        metrics[k] for k in ("si_rmse", "abs_rel", "delta_1", "delta_2", "delta_3")]


def test_prediction_tool_matches_jax(env, patched, monkeypatch):
    root, cfg_path = env
    (root / "cwd_jax").mkdir(exist_ok=True)
    (root / "cwd_port").mkdir(exist_ok=True)
    monkeypatch.chdir(root / "cwd_jax")
    _jax_main(monkeypatch, jax_predictions, "--config", str(cfg_path))
    monkeypatch.chdir(root / "cwd_port")
    assert generate_predictions.main(_port_argv(root, cfg_path)) == 3
    names = sorted(os.listdir(root / "predictions_port"))
    assert names == sorted(os.listdir(root / "predictions_jax")) == [
        f"test_{i:06d}_depth.npy" for i in range(3)]
    for name in names:
        got = np.load(root / "predictions_port" / name)
        want = np.load(root / "predictions_jax" / name)
        assert got.shape == want.shape == (60, 80) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)

    def ids(path):
        with open(path, newline="") as f:
            return [row[0] for row in csv.reader(f)]

    assert ids(root / "cwd_port" / "predictions.csv") == ids(root / "cwd_jax" / "predictions.csv")
    assert len(ids(root / "cwd_port" / "predictions.csv")) == 4  # header and three rows


def test_visualize_matches_jax(env, patched, monkeypatch):
    root, cfg_path = env
    arrays = {"jax": [], "port": []}
    for name, tool in (("jax", jax_visualize), ("port", visualize)):
        def record(pred, gt, index, model_name, loss_map=None, save_path=".",
                   real=tool.save_images, store=arrays[name]):
            store.append((np.asarray(pred), np.asarray(gt), np.asarray(loss_map)))
            real(pred, gt, index, model_name, loss_map, save_path)

        monkeypatch.setattr(tool, "save_images", record)
    out = {k: str(root / f"viz_{k}") for k in arrays}
    _jax_main(monkeypatch, jax_visualize, "--config", str(cfg_path), "--n-samples", "2",
              "--output-dir", out["jax"])
    assert visualize.main(_port_argv(root, cfg_path, "--n-samples", "2",
                                     "--output-dir", out["port"])) == 2
    assert len(arrays["port"]) == len(arrays["jax"]) == 2
    for (pred, gt, lmap), (jpred, jgt, jlmap) in zip(arrays["port"], arrays["jax"]):
        assert pred.shape == gt.shape == lmap.shape == (64, 96)
        np.testing.assert_allclose(pred, jpred, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gt, jgt, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(lmap, jlmap, rtol=2e-3, atol=2e-3)
    figures = {k: sorted(os.listdir(os.path.join(v, "figures"))) for k, v in out.items()}
    assert figures["port"] == figures["jax"] and len(figures["port"]) == 6
    assert f"000001_{MODEL_NAME}_lmap.png" in figures["port"]


def test_visualize_sample_draws_the_grid(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "grid" / "sample.png"
    visualize.visualize_sample(rng.random((3, 16, 24)), rng.random((16, 24)),
                               rng.random((16, 24)), rng.random((16, 24)), save_path=str(path))
    assert path.stat().st_size > 0


# ---------------------------------------------------------------------------
# Parameter counts, devices
# ---------------------------------------------------------------------------


def test_count_params_matches_jax(flagship):  # noqa: F811
    jm, params, stats, port, _ = flagship
    want = jax_count_params(params)
    assert count_params(state_dict_from_flax(params, None)) == want
    dead = sum(p.numel() for name, p in port.named_parameters()
               if name.startswith(port.DEAD_KEY_PREFIXES))
    assert count_params(port) == sum(p.numel() for p in port.parameters()) == want + dead
    # BN's integer counters are not parameters; its running statistics are floats
    sd = port.state_dict()
    assert count_params(sd) == sum(v.numel() for k, v in sd.items()
                                   if not k.endswith("num_batches_tracked"))


def test_trainable_count_matches_jax(flagship):  # noqa: F811
    _, params, _, port, _ = flagship
    assert evaluation.count_trainable_params(port) == \
        jax_evaluation.count_trainable_params(params)


def test_ensure_dir(tmp_path):
    ensure_dir(str(tmp_path / "a" / "b"))
    ensure_dir(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()


@pytest.mark.parametrize("tool", [evaluation, generate_predictions, visualize])
def test_tools_refuse_cuda_without_a_card(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--device", "cuda", "--data-dir", str(tmp_path)])


@pytest.mark.parametrize("tool", [evaluation, generate_predictions, visualize])
def test_tools_set_float32_and_deterministic_convolutions(tool, monkeypatch):
    class Stop(Exception):
        pass

    def stop(cfg):
        raise Stop

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    monkeypatch.setattr(tool, "resolve_paths", stop)
    with pytest.raises(Stop):
        tool.main(["--device", "cpu"])
    assert _flags() == (False, False, True)


def test_bootstrap_model_takes_no_default_device():
    with pytest.raises(TypeError, match="device"):
        common.bootstrap_model(common.parse_config("test", argv=[])[0])

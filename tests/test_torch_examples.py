"""The port's three examples (examples/torch_*.py) on the CPU at a small
geometry: each ``main`` with its input size and its generated dataset's size
and count monkeypatched, writing its outputs.

- torch_simple_unet_baseline: one epoch of its own MSE step at 32x48 on ten
  generated pairs, the printed train and val MSE finite, one native-size
  .npy a test image; its ``mse_loss`` against the JAX example's on the same
  arrays (float32, rtol 1e-6: one mean of squares summed in another order).
- torch_midas_finetune: MiDaS-small warm-started from a local .pth (every
  tensor loaded), one epoch through the port's ``fit`` at 64x96, the best
  checkpoint written.
- torch_da2_finetune: DA-V2-S at 56x84 for one epoch, one 426x560 .npy a test
  image and the CSV, byte for byte mde_tpu's ``process_depth_maps`` over the
  same .npy files.
- Each refuses ``--device cuda`` where no card is visible.
tests/test_torch_no_jax.py imports the three with JAX and mde_tpu refused.
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import simple_unet_baseline as jax_unet
from examples import torch_da2_finetune, torch_midas_finetune, torch_simple_unet_baseline
from mde_tpu.tools.create_prediction_csv import process_depth_maps as jax_process_depth_maps
from mde_tpu_torch.models.factory import build_module
from mde_tpu_torch.models.midas_small import MidasNetSmall
from mde_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(2)

EXAMPLES = [torch_simple_unet_baseline, torch_midas_finetune, torch_da2_finetune]


def test_unet_baseline(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch_simple_unet_baseline, "INPUT_SIZE", (32, 48))
    monkeypatch.setattr(torch_simple_unet_baseline, "SYNTH", {"n_train": 10, "n_test": 2})
    monkeypatch.chdir(tmp_path)
    torch_simple_unet_baseline.main(["--device", "cpu", "--batch-size", "2"])
    out = capsys.readouterr().out
    mse = re.search(r"Epoch 1/1: train MSE (\S+), val MSE (\S+) ", out)
    assert mse and all(math.isfinite(float(v)) for v in mse.groups()), out
    preds = sorted(os.listdir(tmp_path / "predictions_simple_unet"))
    assert len(preds) == 2
    for name in preds:
        depth = np.load(tmp_path / "predictions_simple_unet" / name)
        assert depth.shape == (32, 48) and depth.dtype == np.float32
        assert np.isfinite(depth).all() and (depth >= 0).all() and (depth <= 10).all()


def test_unet_mse_is_the_jax_examples():
    rng = np.random.default_rng(0)
    pred, target = (rng.uniform(0, 10, (4, 32, 48)).astype(np.float32) for _ in range(2))
    got = torch_simple_unet_baseline.mse_loss(torch.from_numpy(pred), torch.from_numpy(target))
    want = jax_unet.mse_loss(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_midas_finetune_warm_started(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch_midas_finetune, "INPUT_SIZE", (64, 96))
    monkeypatch.setattr(torch_midas_finetune, "SYNTH",
                        {"n_train": 10, "n_test": 2, "size": (60, 80)})
    monkeypatch.chdir(tmp_path)
    warm = build_module(MidasNetSmall, {}, "cpu", torch.Generator().manual_seed(3))
    save_checkpoint(str(tmp_path / "warm.pth"), warm)
    history = torch_midas_finetune.main(["--device", "cpu", "--batch-size", "2",
                                         "--pretrained-pth", str(tmp_path / "warm.pth")])
    out = capsys.readouterr().out
    assert f"Warm start: loaded {len(warm.state_dict())} tensors" in out
    assert len(history["val_loss"]) == 1 and all(
        np.isfinite(history["train_loss"] + history["val_loss"]))
    assert "val losses per epoch:" in out
    assert (tmp_path / "results" / "best_model_midas_finetune.pth").exists()


def test_da2_finetune_writes_predictions_and_csv(tmp_path, monkeypatch):
    monkeypatch.setattr(torch_da2_finetune, "INPUT_SIZE", (56, 84))
    monkeypatch.setattr(torch_da2_finetune, "SYNTH", {"n_train": 10, "n_test": 3,
                                                      "size": (60, 80)})
    data = tmp_path / "data"
    from mde_tpu_torch.data import synthetic

    synthetic.generate(str(data), **torch_da2_finetune.SYNTH)
    results = tmp_path / "results"
    history = torch_da2_finetune.main(["--device", "cpu", "--batch-size", "2", "--epochs", "1",
                                       "--data-dir", str(data), "--results-dir", str(results)])
    assert len(history["val_loss"]) == 1 and all(
        np.isfinite(history["train_loss"] + history["val_loss"]))
    preds = sorted(os.listdir(results / "predictions_da2"))
    assert len(preds) == 3
    for name in preds:
        depth = np.load(results / "predictions_da2" / name)
        assert depth.shape == (426, 560) and np.isfinite(depth).all()
    got = (results / "predictions_da2.csv").read_bytes()
    assert got.count(b"\n") == 4  # the header and a row an image
    jax_process_depth_maps(str(results / "predictions_da2"), str(data / "test_list.txt"),
                           str(tmp_path / "jax.csv"))
    assert got == (tmp_path / "jax.csv").read_bytes()


def test_midas_finetune_data_parallel(tmp_path, monkeypatch, capsys):
    """W = 2 forced in this process: the example starts two gloo ranks of
    itself (``python -m examples.torch_midas_finetune``, at its own input
    size), which train one epoch under DistributedDataParallel; only rank 0
    logs (its JSONL file where wandb is absent) and the best checkpoint is
    written once."""
    monkeypatch.setattr(torch_midas_finetune, "data_world", lambda cfg, device: 2)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.chdir(tmp_path)
    from mde_tpu_torch.data import synthetic

    synthetic.generate(str(tmp_path / "data"), n_train=4, n_test=2, size=(60, 80))
    assert torch_midas_finetune.main(["--device", "cpu", "--batch-size", "2",
                                      "--data-dir", str(tmp_path / "data")]) is None
    assert "Starting 2 data-parallel processes" in capsys.readouterr().out
    results = sorted(os.listdir(tmp_path / "results"))
    assert results == ["best_model_midas_finetune.pth", "midas_finetune.log.jsonl"], results


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda m: m.__name__.split(".")[-1])
def test_cuda_refused_without_a_card(example, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device is visible"):
        example.main(["--device", "cuda", "--data-dir", str(tmp_path)])

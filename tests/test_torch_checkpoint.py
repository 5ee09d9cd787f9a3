"""The port's checkpoint reader against mde_tpu's format, and the tools'
float32 precision.

- mde_tpu writes flax msgpack to the same ``best_model_{name}.pth`` path
  that the port writes a torch zip to. The port's loaders read the header
  first: a file that mde_tpu's ``save_checkpoint`` wrote raises a
  ValueError that names ``state_dict_from_flax``, through
  ``load_checkpoint``, ``load_training_checkpoint`` and ``bootstrap_model``;
  a ``.pth`` that the port wrote still loads.
- ``build_service`` and the training CLI turn TF32 off for cuDNN and for
  matmuls (float32 throughout, like the JAX predict step). Each test puts
  both flags back as it found them.
"""

import numpy as np
import pytest
import torch

from mde_tpu.train import checkpoint as jax_checkpoint
from mde_tpu_torch.core import config
from mde_tpu_torch.models.factory import build_model
from mde_tpu_torch.tools import main as train_cli
from mde_tpu_torch.tools.common import bootstrap_model
from mde_tpu_torch.tools.serve import build_service
from mde_tpu_torch.train.checkpoint import (checkpoint_path, load_checkpoint,
                                            load_training_checkpoint, save_checkpoint)
from tests.test_torch_serve import GEOMETRY


def _cfg(tmp_path):
    return config.from_dict({**GEOMETRY, "paths": {"results_dir": str(tmp_path)}})


@pytest.fixture
def flax_checkpoint(tmp_path):
    """A best-model file as mde_tpu writes it, at the port's path."""
    path = checkpoint_path(str(tmp_path), "serve_port")
    jax_checkpoint.save_checkpoint(path, {"epoch": 3, "params": {"w": np.ones((2, 3), np.float32)}})
    with open(path, "rb") as f:
        assert f.read(2) != b"PK"
    return path


@pytest.fixture
def tf32_flags():
    """Both TF32 flags set to True for the test, restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _tf32():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("reader", ["load_checkpoint", "load_training_checkpoint",
                                    "bootstrap_model"])
def test_flax_checkpoint_names_the_converter(tmp_path, flax_checkpoint, reader):
    cfg = _cfg(tmp_path)
    with pytest.raises(ValueError, match="state_dict_from_flax"):
        if reader == "load_checkpoint":
            load_checkpoint(build_model(cfg.model, "cpu", torch.Generator().manual_seed(0)),
                            flax_checkpoint)
        elif reader == "load_training_checkpoint":
            load_training_checkpoint(flax_checkpoint)
        else:
            bootstrap_model(cfg, "cpu", checkpoint=flax_checkpoint)


def test_port_checkpoint_still_loads(tmp_path):
    cfg = _cfg(tmp_path)
    model = build_model(cfg.model, "cpu", torch.Generator().manual_seed(1))
    path = checkpoint_path(str(tmp_path), "serve_port")
    save_checkpoint(path, model)
    loaded, report = bootstrap_model(cfg, "cpu", checkpoint=path)
    assert report["loaded"] == len(model.state_dict()) and not report["shape_mismatch"]
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_build_service_turns_tf32_off(tmp_path, tf32_flags):
    assert _tf32() == (True, True)
    service = build_service(_cfg(tmp_path), "cpu", max_batch=1, warmup=False,
                            allow_uninitialized=True)
    service.close()
    assert _tf32() == (False, False)


def test_training_cli_turns_tf32_off(monkeypatch, tf32_flags):
    """The CLI sets the precision right after parsing its arguments."""
    class Stop(Exception):
        pass

    def stop(cfg):
        raise Stop

    monkeypatch.setattr(train_cli, "resolve_paths", stop)
    with pytest.raises(Stop):
        train_cli.main(["--device", "cpu"])
    assert _tf32() == (False, False)

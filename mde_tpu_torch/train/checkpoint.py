"""Checkpoints as PyTorch ``.pth`` state_dicts (port of mde_tpu/train/checkpoint.py).

The port's module names are the reference checkpoint's key grammar, so its
state_dict is a reference ``.pth`` and a reference ``.pth`` loads directly.
Loading is the reference's strict=False, shape-filtered merge
(mde_tpu/train/torch_import.py:1146-1194) with the DataParallel ``module.``
prefix stripped (:44-46), and it reports what it did.

A training checkpoint is the reference's payload dict (src/main.py:206-224):
``TRAINING_KEYS``, with the model under ``model_state_dict``, so
``load_checkpoint`` and the server read it like a bare state_dict.

mde_tpu writes flax msgpack to the same ``best_model_{name}.pth`` path. A
torch checkpoint is a zip archive (magic ``PK``), so the loaders read the
first bytes before ``torch.load``, as mde_tpu/train/checkpoint.py does the
other way round, and name the converter for anything else.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn


def checkpoint_path(results_dir: str, model_name: str) -> str:
    """The reference's best-model filename contract."""
    return os.path.join(results_dir, f"best_model_{model_name}.pth")


TRAINING_KEYS = ("epoch", "model_state_dict", "optimizer_state_dict", "best_val_loss",
                 "best_epoch", "early_stopping_counter", "train_loss", "val_loss", "config")


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state_dict(model: nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_checkpoint(path: str, model: nn.Module) -> None:
    """Write ``model``'s state_dict (on the CPU) atomically."""
    _atomic_save(_cpu_state_dict(model), path)


def save_training_checkpoint(path: str, model: nn.Module, optimizer, **fields) -> None:
    """Write the reference's training payload atomically: the model's and the
    optimizer's state plus ``fields`` (the other ``TRAINING_KEYS``)."""
    missing = set(TRAINING_KEYS) - {"model_state_dict", "optimizer_state_dict"} - set(fields)
    if missing:
        raise ValueError(f"training checkpoint lacks {sorted(missing)}")
    _atomic_save({"model_state_dict": _cpu_state_dict(model),
                  "optimizer_state_dict": optimizer.state_dict(), **fields}, path)


def _torch_load(path: str):
    """``torch.load`` of a zip checkpoint on the CPU; any other file raises
    ValueError before the unpickler sees it."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head != b"PK":
        raise ValueError(
            f"{path} is not a PyTorch zip checkpoint; it looks like an mde_tpu flax (msgpack) "
            "checkpoint: bring its weights across with "
            "mde_tpu_torch.train.convert.state_dict_from_flax and save them with save_checkpoint")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_training_checkpoint(path: str) -> dict:
    """The payload ``save_training_checkpoint`` wrote, tensors on the CPU."""
    return _torch_load(path)


def _unwrap(obj) -> dict:
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict", "model"):
            if isinstance(obj.get(key), dict):
                return obj[key]
    return obj


def remove_module_prefix(key: str) -> str:
    """Strip a single leading 'module.' (DataParallel wrapper)."""
    return key[len("module."):] if key.startswith("module.") else key


@torch.no_grad()
def load_state_dict(model: nn.Module, state_dict: dict) -> dict:
    """Merge the entries of ``state_dict`` whose key and shape match ``model``.

    Returns {"loaded": n, "shape_mismatch": [...], "unexpected": [...],
    "missing": [...]}; ``missing`` lists the model's keys left untouched.
    """
    own = model.state_dict()
    report = {"loaded": 0, "shape_mismatch": [], "unexpected": [], "missing": []}
    seen = set()
    for key, value in state_dict.items():
        key = remove_module_prefix(key)
        if key not in own:
            report["unexpected"].append(key)
        elif tuple(value.shape) != tuple(own[key].shape):
            report["shape_mismatch"].append(key)
        else:
            own[key].copy_(torch.as_tensor(value))
            report["loaded"] += 1
            seen.add(key)
    report["missing"] = [k for k in own if k not in seen]
    return report


def load_checkpoint(model: nn.Module, path: str) -> dict:
    """Load a ``.pth`` into ``model`` in place; returns the merge report."""
    return load_state_dict(model, _unwrap(_torch_load(path)))

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

Under tensor parallelism (``parallel.tensor``) a rank holds a share of the
sharded layers. ``save_checkpoint`` and ``save_training_checkpoint`` gather
the shares over the model group (every rank calls them; process 0 writes)
and write the full reference grammar, AdamW's moments gathered by parameter
name, as mde_tpu's ``save_checkpoint`` gathers; ``load_state_dict`` cuts a
full state_dict to the rank's share. ``save_checkpoint_sharded`` /
``load_checkpoint_sharded`` (mde_tpu/train/checkpoint.py:79-120) write each
model rank's share of data index 0 with an index, and restore them onto
any (data, model) layout or onto one process with identical values.
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn as nn

from ..parallel import distributed as dist
from ..parallel.tensor import (full_optimizer_state, full_state_dict, gather_state_dict,
                               gather_tensor, parameter_names, shard_optimizer_state,
                               shard_tensor, share_of)


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


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def _optimizer_cpu(state: dict) -> dict:
    return {"param_groups": state["param_groups"],
            "state": {i: {k: v.cpu() if torch.is_tensor(v) else v for k, v in entry.items()}
                      for i, entry in state["state"].items()}}


def _writes(model: nn.Module) -> bool:
    """Whether this rank takes part in a full checkpoint's save: every rank
    of a tensor-parallel model gathers, process 0 alone writes."""
    return share_of(model) is not None or dist.is_primary()


def save_checkpoint(path: str, model: nn.Module) -> None:
    """Write ``model``'s full state_dict (on the CPU) atomically, from process
    0 (module docstring: every rank of a tensor-parallel model calls it)."""
    if not _writes(model):
        return
    state = _cpu(full_state_dict(model))
    if dist.is_primary():
        _atomic_save(state, path)


def save_training_checkpoint(path: str, model: nn.Module, optimizer, **fields) -> None:
    """Write the reference's training payload atomically from process 0: the
    model's and the optimizer's full state plus ``fields`` (the other
    ``TRAINING_KEYS``)."""
    missing = set(TRAINING_KEYS) - {"model_state_dict", "optimizer_state_dict"} - set(fields)
    if missing:
        raise ValueError(f"training checkpoint lacks {sorted(missing)}")
    if not _writes(model):
        return
    state = _cpu(full_state_dict(model))
    opt = _optimizer_cpu(full_optimizer_state(model, optimizer))
    if dist.is_primary():
        _atomic_save({"model_state_dict": state, "optimizer_state_dict": opt, **fields}, path)


def load_optimizer_state(model: nn.Module, optimizer, state: dict) -> None:
    """Load a full optimizer state_dict (a training checkpoint's) into
    ``optimizer``, cut to this rank's share of a tensor-parallel model."""
    optimizer.load_state_dict(shard_optimizer_state(model, optimizer, state))


SHARD_INDEX = "index.json"


def _shard_file(rank: int, size: int) -> str:
    return f"model_rank{rank}_of{size}.pt"


def save_checkpoint_sharded(dirpath: str, model: nn.Module, optimizer=None, **fields) -> None:
    """Write each model rank's share (of data index 0; its data peers hold
    the same) to ``dirpath``: its state_dict, its optimizer's state and its
    parameter names, as ``torch.save`` a rank, then ``index.json`` (T, the
    layout, the files and ``fields``, which must be JSON) from process 0,
    after every share is on disk. Every rank calls it."""
    share = share_of(model)
    size, rank = (share.size, share.rank) if share else (1, 0)
    if dist.data_index() == 0:
        payload = {"model_state_dict": _cpu(model.state_dict())}
        if optimizer is not None:
            payload["optimizer_state_dict"] = _optimizer_cpu(optimizer.state_dict())
            payload["parameter_names"] = parameter_names(model, optimizer)
        _atomic_save(payload, os.path.join(dirpath, _shard_file(rank, size)))
    dist.barrier("sharded_checkpoint_shares")
    if dist.is_primary():
        index = {"model": size, "data": dist.data_count(),
                 "layout": share.layout if share else {},
                 "files": [_shard_file(r, size) for r in range(size)], "fields": fields}
        tmp = os.path.join(dirpath, SHARD_INDEX + ".tmp")
        with open(tmp, "w") as f:
            json.dump(index, f)
        os.replace(tmp, os.path.join(dirpath, SHARD_INDEX))
    dist.barrier("sharded_checkpoint_index")


def load_checkpoint_sharded(dirpath: str, model: nn.Module, optimizer=None) -> dict:
    """Restore what ``save_checkpoint_sharded`` wrote onto ``model`` (and
    ``optimizer``) at this process's layout: the shares are gathered to the
    full state_dict bit for bit, then cut to this rank's share. Returns the
    index's ``fields``."""
    with open(os.path.join(dirpath, SHARD_INDEX)) as f:
        index = json.load(f)
    shares = [_torch_load(os.path.join(dirpath, name)) for name in index["files"]]
    layout = index["layout"]
    report = load_state_dict(model, gather_state_dict([s["model_state_dict"] for s in shares],
                                                      layout))
    if report["shape_mismatch"] or report["unexpected"]:
        raise ValueError(f"{dirpath} does not fit the model: {report}")
    if optimizer is not None:
        names = shares[0]["parameter_names"]
        first = shares[0]["optimizer_state_dict"]
        full = {"param_groups": first["param_groups"], "state": {}}
        for i, entry in first["state"].items():
            name = names[int(i)]
            full["state"][i] = {
                k: gather_tensor([s["optimizer_state_dict"]["state"][i][k] for s in shares],
                                 name, layout.get(name, "replicated"))
                if torch.is_tensor(v) and v.dim() else v for k, v in entry.items()}
        load_optimizer_state(model, optimizer, full)
    return index["fields"]


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
    """Merge the entries of ``state_dict`` whose key and shape match ``model``;
    a full state_dict is cut to this rank's share of a tensor-parallel model
    first.

    Returns {"loaded": n, "shape_mismatch": [...], "unexpected": [...],
    "missing": [...]}; ``missing`` lists the model's keys left untouched.
    """
    share = share_of(model)
    if share is not None:
        def cut(key, value):
            try:
                return shard_tensor(value, key, share.layout.get(key, "replicated"), share.size,
                                    share.rank)
            except (ValueError, RuntimeError):
                return value  # not a full tensor: reported as a shape mismatch below

        state_dict = {k: cut(remove_module_prefix(k), v) for k, v in state_dict.items()}
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

"""The (data, model) world, its row layout and the tensor-parallel layout
(port of mde_tpu/parallel/mesh.py).

The JAX package trains over a ('data', 'model') mesh under GSPMD, which
inserts the gradient all-reduce, the global BatchNorm statistics and the
Megatron collectives itself. The port runs one process per card: ``mesh_world``
picks (data, model) as ``make_training_mesh`` picks the mesh, ``local_rows``
says which rows of a global batch a data index holds (the stand-in for
``shard_batch``), ``tp_layout`` is ``tp_param_spec`` on the port's
state_dict (``parallel.tensor`` swaps the layers it shards), and
``data_parallel`` wraps the model in ``DistributedDataParallel`` over the
data group with the cross-process BatchNorm.
"""

from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch

from . import distributed as dist
from .sync_batchnorm import convert_sync_batchnorm


def clamp_data_axis(requested: int, batch_size: int, n_devices: int) -> int:
    """Largest usable data axis: divides ``batch_size``, at most ``n_devices``
    (``requested`` -1 means ``n_devices``)."""
    if requested == -1:
        requested = n_devices
    requested = min(requested, n_devices)
    while requested > 1 and batch_size % requested != 0:
        requested -= 1
    return max(requested, 1)


def mesh_world(cfg, device: str, batch_size: Optional[int] = None) -> tuple[int, int]:
    """(data, model): the data-parallel ranks and T, the ranks of one data
    index that share a model (``framework.mesh.model``), of a run whose
    global batch is ``batch_size`` (default ``training.batch_size``; the
    server passes its ``--max-batch``).

    As ``make_training_mesh(cfg, batch_size)`` (mde_tpu/parallel/mesh.py:78-85):
    ``usable`` = cards // model, and ``framework.mesh.data`` (-1: all of
    them) is clamped to divide the batch. ``--device cuda`` counts the
    visible cards; on the CPU, or with one named card (``cuda:N``, ranks
    sharing it), processes are not bounded by cards and -1 means one. Under
    a launcher the world is its process count, which the config must allow.
    Every model takes the model axis (``tp_layout`` says what a rank holds).
    """
    mesh = cfg.framework.get("mesh", {})
    model = int(mesh.get("model", 1))
    if model < 1:
        raise ValueError(f"framework.mesh.model={model}: at least 1")
    requested = int(mesh.get("data", -1))
    batch_size = int(cfg.training.batch_size if batch_size is None else batch_size)
    if dist.is_multiprocess():
        w = dist.process_count()
        d = w // model
        if w % model or requested not in (-1, d) or batch_size % d:
            raise ValueError(f"{w} processes were launched: framework.mesh.model ({model}) must "
                             f"divide them, framework.mesh.data must be -1 or {d} (it is "
                             f"{requested}) and the batch must split over {d} (it is "
                             f"{batch_size})")
        return d, model
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        usable = torch.cuda.device_count() // model
        if usable < 1:
            raise ValueError(f"framework.mesh.model={model} needs {model} cards, "
                             f"{torch.cuda.device_count()} visible")
    else:
        usable = max(requested, 1)
    return clamp_data_axis(requested, batch_size, usable), model


def data_world(cfg, device: str) -> int:
    """W of a data-parallel run (``mesh_world``'s data axis) for the
    examples, which train on the data axis alone."""
    data, model = mesh_world(cfg, device)
    if model > 1:
        raise ValueError(f"framework.mesh.model={model}: the examples train on the data axis "
                         "alone; the training CLI (mde_tpu_torch.tools.main) takes the model axis")
    return data


def local_rows(global_rows: int, accum_steps: int, process: int, count: int) -> Optional[np.ndarray]:
    """Indices into a global batch of the rows process ``process`` of
    ``count`` holds, or None when the batch runs replicated (whole on every
    process).

    The train step splits a batch into ``accum_steps`` microbatches of
    m = rows / accum_steps consecutive rows (mde_tpu/train/trainer.py:226-231),
    and each microbatch is spread over the processes: process p holds rows
    [i m + p m / W, i m + (p + 1) m / W) of microbatch i, in order. With one
    microbatch this is ``local_row_block``. A batch runs replicated when m
    does not split over W.
    """
    if global_rows % accum_steps:
        return None
    m = global_rows // accum_steps
    if m % count:
        return None
    per = m // count
    return np.concatenate([np.arange(i * m + process * per, i * m + (process + 1) * per)
                           for i in range(accum_steps)])


def data_parallel(model: torch.nn.Module, device: torch.device):
    """``model`` with its BatchNorm layers made cross-process (in place, the
    same parameters and buffers), wrapped in ``DistributedDataParallel`` over
    the data group: the gradient average and DDP's first broadcast of the
    parameters stay among the ranks that hold the same share of them.
    Buffers are not broadcast a step (every rank computes the same running
    statistics); the model's dead parameters (its ``DEAD_KEY_PREFIXES``:
    modules no forward reads) are left out of the gradient reduction."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    convert_sync_batchnorm(model)
    dead = getattr(model, "DEAD_KEY_PREFIXES", ())
    ignored = [n for n, _ in model.named_parameters() if dead and n.startswith(dead)]
    DDP._set_params_and_buffers_to_ignore_for_model(model, ignored)
    # no buffer broadcast a forward (torch 2.13 renames the option)
    no_broadcast = ({"forward_sync_buffers": False}
                    if "forward_sync_buffers" in inspect.signature(DDP).parameters
                    else {"broadcast_buffers": False})
    card = None
    if device.type == "cuda":
        card = [device.index if device.index is not None else torch.cuda.current_device()]
    return DDP(model, device_ids=card, process_group=dist.data_group(), **no_broadcast)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a ``DistributedDataParallel``, or ``model`` itself."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    return model.module if isinstance(model, DDP) else model


# ------------------------------------------------------------ tensor parallel
#
# tp_param_spec's rule (mde_tpu/parallel/mesh.py:193-257) on the port's
# modules: each attention and MLP declares what a model rank holds of it,
# ``tp_linears`` (Linears below it by dotted path: "column" for qkv, fc1, q,
# k, v, "row" for proj, fc2) and ``tp_heads`` (its own per-head
# parameters). Everything no module declares stays replicated.


def declared_parts(model: torch.nn.Module) -> dict:
    """{state_dict key: (kind, head count of its owner or None)} for the
    parts a module names in ``tp_linears`` (a Linear's weight, and a column
    layer's bias with it) and ``tp_heads`` (its own parameters). A
    ``tp_linears`` path must name an ``nn.Linear``."""
    out = {}
    for prefix, module in model.named_modules():
        heads = getattr(module, "num_heads", None)
        at = f"{prefix}." if prefix else ""
        for path, kind in getattr(module, "tp_linears", {}).items():
            if type(module.get_submodule(path)) is not torch.nn.Linear:
                raise ValueError(f"{at}{path}: tensor parallelism shards an nn.Linear, not "
                                 f"{type(module.get_submodule(path)).__name__}")
            out[f"{at}{path}.weight"] = (kind, heads)
            if kind == "column":
                out[f"{at}{path}.bias"] = (kind, heads)
        for name, kind in getattr(module, "tp_heads", {}).items():
            out[f"{at}{name}"] = (kind, heads)
    return out


def tp_layout(model: torch.nn.Module, size: int) -> dict:
    """Each key of ``model``'s (full) state_dict: how ``size`` model ranks
    hold it. "column": split on dim 0 (a column layer's output features and
    bias, a fused ``qkv`` head by head within q, k and v; a per-head
    parameter with the heads first: BEiT's and Swin V2's ``q_bias`` and
    ``v_bias``, V2's ``logit_scale`` and ``cpb_mlp.2``); "row": split on dim
    1 (a row layer's input features; its bias whole); "heads": split on the
    last dim (a relative-position bias table, (offsets, heads)); or
    "replicated": every key no module declares (``declared_parts``), and a
    declared one whose split does not divide by T.

    Two rules beyond ``tp_param_spec``'s, which compute the same function
    and which tests/test_torch_tensor_parallel.py and
    tests/test_torch_tensor_parallel_zoo.py state against it:

    - whole heads: a part of a module with ``num_heads`` (an attention) is
      sharded only where the heads divide by T, so that each rank holds
      whole heads; elsewhere the attention stays replicated, tables and
      all (GSPMD may split a qkv kernel between heads, and its collectives
      then give the same function);
    - the per-head tables (``tp_heads``: BEiT's and Swin V1's bias tables,
      V2's logit scales and the last layer of its position-bias MLP) are
      sharded with their heads, where GSPMD keeps them whole and reshards
      them: a head's rank holds what that head owns, so no table needs a
      gradient all-reduce and AdamW's moments shard with it.
    """
    from .tensor import split_dim

    declared = declared_parts(model)
    layout = {}
    for key, t in model.state_dict(keep_vars=True).items():
        kind, heads = declared.get(key, ("replicated", None))
        if kind != "replicated":
            dim, blocks = split_dim(key, kind, t.dim())
            if (t.shape[dim] // blocks) % size or (heads is not None and heads % size):
                kind = "replicated"
        layout[key] = kind
    return layout

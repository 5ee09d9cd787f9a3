"""The data-parallel world and its row layout (port of the data axis of
mde_tpu/parallel/mesh.py).

The JAX package trains over a ('data', 'model') mesh under GSPMD, which
inserts the gradient all-reduce and the global BatchNorm statistics itself.
The port runs one process per card on the data axis: ``data_world`` picks W
as ``make_training_mesh`` picks the data axis, ``local_rows`` says which rows
of a global batch a process holds (the stand-in for ``shard_batch``), and
``data_parallel`` wraps the model in ``DistributedDataParallel`` with the
cross-process BatchNorm. The model axis (tensor parallelism) is not ported:
``framework.mesh.model > 1`` raises (ROADMAP, Queue 1, item 5b).
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


def data_world(cfg, device: str) -> int:
    """W, the data-parallel processes of a training run: ``framework.mesh.data``
    (-1: every visible card) clamped to divide ``training.batch_size``, as
    ``make_training_mesh`` clamps the data axis. ``--device cuda`` counts the
    visible cards; on the CPU, or with one named card (``cuda:N``, ranks
    sharing it), processes are not bounded by cards and -1 means one.
    Under a launcher W is its process count, which the config must allow.
    """
    mesh = cfg.framework.get("mesh", {})
    if int(mesh.get("model", 1)) > 1:
        raise ValueError(
            f"framework.mesh.model={mesh.get('model')}: tensor parallelism is not ported to "
            "mde_tpu_torch yet (ROADMAP.md, Queue 1, item 5b)")
    requested = int(mesh.get("data", -1))
    batch_size = int(cfg.training.batch_size)
    if dist.is_multiprocess():
        w = dist.process_count()
        if requested not in (-1, w) or batch_size % w:
            raise ValueError(f"{w} processes were launched: framework.mesh.data must be -1 or "
                             f"{w} (it is {requested}) and training.batch_size must split over "
                             f"them (it is {batch_size})")
        return w
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
    else:
        n = max(requested, 1)
    return clamp_data_axis(requested, batch_size, n)


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
    same parameters and buffers), wrapped in ``DistributedDataParallel``.
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
    return DDP(model, device_ids=card, **no_broadcast)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a ``DistributedDataParallel``, or ``model`` itself."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    return model.module if isinstance(model, DDP) else model

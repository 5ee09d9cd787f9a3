"""The multi-process runtime (port of mde_tpu/parallel/distributed.py).

One process per card, joined by ``torch.distributed``: NCCL between cards,
gloo on the CPU or where the caller names it (two ranks sharing one card,
which NCCL refuses). The data contract is the JAX package's:

- every process computes the same global batch order (same seed, same
  shuffle) and decodes only its rows of each batch
  (``HostLoader(process_shard=...)``; ``parallel.mesh.local_rows`` gives the
  layout);
- losses and metrics of a sharded batch are reduced across the processes
  (``global_sum``, ``global_max``), so every process holds the same global
  numbers and takes the same early-stopping branch;
- gradients are averaged by ``DistributedDataParallel`` and BatchNorm's batch
  statistics are global (``parallel.sync_batchnorm``), so a step of W ranks
  is the one-process step on the global batch;
- only process 0 writes checkpoints and logs; ``barrier`` keeps the others
  from racing past a save.

Under tensor parallelism (``framework.mesh.model`` = T > 1) the world is a
(data, model) grid, as ``make_mesh`` reshapes the devices to (data, model):
rank p sits at data index p // T and model index p % T, so a model group is
T consecutive ranks and a data group the ranks of one model index
(``set_model_axis`` makes both kinds of group). The rows of a batch, the
loss sums, the metric sums, BatchNorm's statistics and the gradient average
go over the data group; the Megatron collectives of ``parallel.tensor`` go
over the model group.

The server (tools/serve.py) runs over the same grid: rank 0 announces each
device step with a header and broadcasts its bucket, each data index takes
its rows by ``shard_batch``'s rule (``bucket_rows``), and ``gather_rows``
brings them back to rank 0 over the data group.

Launchers: the training CLI, the server and the offline tools spawn one
process per card themselves (``tools/common.py::enter_world``); under
torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or with the ``MDE_DIST_*`` variables each process joins
(``initialize_from_env``). A rank's card is ``cuda:{LOCAL_RANK}`` (the
process id where ``LOCAL_RANK`` is unset). A collective that waits longer
than ``GROUP_TIMEOUT`` (600 s) fails, so that a rank that died ends the
run.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# MDE_DIST_BACKEND names the backend (gloo or nccl); by default NCCL on
# CUDA and gloo on the CPU.
BACKENDS = ("gloo", "nccl")

# How long a collective waits for its peers before it fails, so that a rank
# that died ends the run instead of hanging it.
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK``, else the process id
    (every rank on one host), else 0."""
    for name in ("LOCAL_RANK", "MDE_DIST_PROCESS_ID", "RANK"):
        if os.environ.get(name):
            return int(os.environ[name])
    return 0


def rank_device(device: str, world: Optional[int] = None) -> torch.device:
    """The card of this rank for the tools' ``--device``: ``cpu`` stays the
    CPU, ``cuda`` becomes ``cuda:{local_rank()}`` when more than one process
    runs, and ``cuda:N`` keeps card N for every rank (cards shared: gloo
    only). A rank whose card is not visible raises: it never falls back."""
    dev = torch.device(device)
    world = process_count() if world is None else world
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is visible")
    if dev.index is None:
        if world <= 1:
            return dev
        dev = torch.device("cuda", local_rank())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local_rank()}: card {dev} is not visible "
                           f"({torch.cuda.device_count()} visible)")
    return dev


def initialize(init_method: str, num_processes: int, process_id: int,
               device: torch.device, backend: Optional[str] = None) -> None:
    """Join the process group (idempotent). ``backend`` None takes NCCL for a
    CUDA ``device`` and gloo for the CPU; NCCL is given the rank's card
    (``torch.cuda.set_device`` first). A backend that cannot start raises.
    Every group's collectives fail after ``GROUP_TIMEOUT``."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {device}")
    kwargs = {}
    if device.type == "cuda":
        if device.index is None:  # a world of one given "cuda"
            device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=GROUP_TIMEOUT, **kwargs)


def initialize_from_env(device: str = "cpu") -> bool:
    """Join the process group the environment describes; returns True if it
    did (a multi-process run), False where no launcher variable is set.

    - ``MDE_DIST_COORDINATOR`` (host:port of process 0), ``MDE_DIST_NUM_PROCESSES``,
      ``MDE_DIST_PROCESS_ID``; ``MDE_DIST_CPU`` forces the CPU and gloo;
    - else torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
    - ``MDE_DIST_BACKEND`` names the backend in either case.

    ``device`` is the tool's ``--device``; the rank's card comes from
    ``rank_device``.
    """
    env = os.environ
    if env.get("MDE_DIST_COORDINATOR"):
        init_method = f"tcp://{env['MDE_DIST_COORDINATOR']}"
        n, p = int(env["MDE_DIST_NUM_PROCESSES"]), int(env["MDE_DIST_PROCESS_ID"])
        if env.get("MDE_DIST_CPU"):
            device = "cpu"
    elif env.get("WORLD_SIZE") and env.get("RANK"):
        init_method = "env://"
        n, p = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    initialize(init_method, n, p, rank_device(device, n), env.get("MDE_DIST_BACKEND") or None)
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    _AXES.update(model=1, model_group=None, data_group=None)
    if dist.is_initialized():
        dist.destroy_process_group()


# The model axis: T and this rank's two groups (None: the default group, the
# whole world; ``set_model_axis`` names them).
_AXES = {"model": 1, "model_group": None, "data_group": None}


def set_model_axis(model: int) -> None:
    """Split the world into (data, model) = (W / ``model``, ``model``) groups.

    Every rank calls it with the same ``model``, and creates every group in
    the same order (``dist.new_group`` is collective): first the data
    indices' model groups, ranks [d T, (d + 1) T), then the model indices'
    data groups, ranks m, m + T, .... A group that is the whole world stays
    the default group. ``model`` 1 leaves the data group the world, as a
    data-parallel run has it.
    """
    world, rank = process_count(), process_index()
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide {world} processes")
    groups = {"model_group": None, "data_group": None}
    if model > 1 and world > 1:
        data = world // model
        layouts = {"model_group": [list(range(d * model, (d + 1) * model)) for d in range(data)],
                   "data_group": [list(range(m, world, model)) for m in range(model)]}
        for key, layout in layouts.items():
            for ranks in layout:
                group = (dist.new_group(ranks, timeout=GROUP_TIMEOUT) if len(ranks) < world
                         else None)
                if rank in ranks:
                    groups[key] = group
    _AXES.update(model=model, **groups)


def model_count() -> int:
    """T, the ranks that share one data index (1 without tensor parallelism)."""
    return _AXES["model"]


def model_index() -> int:
    return process_index() % model_count()


def data_count() -> int:
    """The data-parallel ranks: the world over T."""
    return process_count() // model_count()


def data_index() -> int:
    return process_index() // model_count()


def model_group():
    """This rank's model group (its data index's T ranks), or None for the
    default group."""
    return _AXES["model_group"]


def data_group():
    """This rank's data group (the ranks of its model index), or None for the
    default group."""
    return _AXES["data_group"]


def group_size(group) -> int:
    """The ranks of ``group`` (None: the default group; 1 with none joined)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns checkpoint and log side effects."""
    return process_index() == 0


def is_multiprocess() -> bool:
    return process_count() > 1


def barrier(name: str = "mde_barrier", group=None) -> None:
    """Block until every process of ``group`` (None: all of them) reaches this
    point (no-op in one process). ``name`` says in a traceback which barrier
    hung."""
    del name
    if group_size(group) > 1:
        dist.barrier(group=group)


def local_row_block(global_rows: int, process: Optional[int] = None,
                    count: Optional[int] = None) -> tuple[int, int]:
    """[start, stop) of this process's contiguous row block of a global
    batch; ``process``/``count`` default to the runtime's values."""
    p = process_index() if process is None else process
    n = process_count() if count is None else count
    if global_rows % n:
        raise ValueError(f"global batch of {global_rows} rows does not split over {n} processes")
    per = global_rows // n
    return p * per, (p + 1) * per


class _GlobalSum(torch.autograd.Function):
    """Sum over a group; the backward passes the gradient through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the processes of ``group`` (None: all of them),
    differentiable.

    The caller computes the same function of the sum on every process, so
    each process's gradient of that sum is the same, and the gradient of its
    own share is that gradient unchanged: the backward communicates nothing.
    Each process's backward is then the global loss's through its own rows;
    ``DistributedDataParallel`` averages over the processes, so the train
    step scales the loss by the process count.
    """
    return _GlobalSum.apply(x, group) if group_size(group) > 1 else x


def global_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max over the processes of ``group`` (no gradient)."""
    out = x.detach().clone()
    if group_size(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_reduce_floats(values, device, group=None) -> list[float]:
    """Python floats summed over the processes of ``group``, in float64 on
    ``device``."""
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t.tolist()


def broadcast_floats(values, device) -> list[float]:
    """Process 0's Python floats on every process, in float64 on ``device``."""
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    if is_multiprocess():
        dist.broadcast(t, 0)
    return t.tolist()


# ------------------------------------------------------------------ serving
#
# The server's world (tools/serve.py): rank 0 owns the HTTP server and the
# batcher, and every collective it issues is announced by a header that the
# other ranks receive in the same order. Tensors move on the rank's card
# under NCCL and on the CPU under gloo.

SERVE_STOP, SERVE_PREDICT, SERVE_FETCH, SERVE_IDLE = 0, 1, 2, 3


def comm_device(device: torch.device) -> torch.device:
    """Where this rank's serving collectives hold their tensors: ``device``
    under NCCL, the CPU under gloo."""
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def broadcast_header(op: int, size: int, device: torch.device) -> tuple[int, int]:
    """(op, bucket size), process 0's on every process: process 0 passes
    its own, the others anything."""
    t = torch.tensor([op, size], dtype=torch.int64, device=comm_device(device))
    dist.broadcast(t, 0)
    op, size = t.tolist()
    return int(op), int(size)


def broadcast_bucket(bucket: Optional[np.ndarray], shape, device: torch.device) -> torch.Tensor:
    """Process 0's uint8 ``bucket`` (None elsewhere) of ``shape`` on every
    process, on ``comm_device(device)``."""
    where = comm_device(device)
    if is_primary():
        t = torch.from_numpy(np.ascontiguousarray(bucket)).to(where)
    else:
        t = torch.empty(tuple(shape), dtype=torch.uint8, device=where)
    dist.broadcast(t, 0)
    return t


def bucket_rows(bucket: int, index: Optional[int] = None,
                count: Optional[int] = None) -> Optional[tuple[int, int]]:
    """[start, stop) of data index ``index``'s rows of a bucket, by
    ``shard_batch``'s rule (mde_tpu/parallel/mesh.py:93-124): a contiguous
    block of each data index when the bucket divides over the ``count``
    data indices; None when it does not, and the bucket runs whole.
    ``index``/``count`` default to this rank's."""
    index = data_index() if index is None else index
    count = data_count() if count is None else count
    return None if bucket % count else local_row_block(bucket, index, count)


def gather_rows(rows: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The data indices' ``rows`` (equal shapes) in data-index order, over
    this rank's data group; each model index's data group gathers its own."""
    if group_size(data_group()) == 1:
        return rows
    rows = rows.to(comm_device(device)).contiguous()
    parts = [torch.empty_like(rows) for _ in range(data_count())]
    dist.all_gather(parts, rows, group=data_group())  # the list form: gloo has it on CUDA
    return torch.cat(parts)

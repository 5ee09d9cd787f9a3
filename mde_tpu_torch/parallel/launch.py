"""One process per rank on this host, joined through the ``MDE_DIST_*``
variables; and the data-parallel run the tests and the smoke run hold
against one process.

``spawn`` is how the tools start W processes themselves: each runs
``python -m <module> <argv>`` with ``MDE_DIST_COORDINATOR`` (a free
localhost port), ``MDE_DIST_NUM_PROCESSES``, ``MDE_DIST_PROCESS_ID`` and
``LOCAL_RANK`` set, ``MDE_DIST_CPU`` on the CPU, and ``MDE_DIST_BACKEND``
passed on. If any rank fails, the others are stopped and its exit code is
returned. A SIGTERM or SIGINT to the process that spawned them is passed on
to every rank, and the ranks are waited for: a server's ranks stop in order
and exit 0 (tools/serve.py), a training rank ends at the signal.

``python -m mde_tpu_torch.parallel.launch SPEC.json`` is one rank of a
checked run (``run_rank``): the jobs of the spec (the cross-process
BatchNorm on one layer, the Megatron layers of an MLP, train steps, or
``fit``) in turn, each over its own (data, model) split of the world
(``model_axis``: T), each rank writing what it saw to
``<out>/<job>_rank<p>.pt``, which the caller holds against one process.
``run`` spawns the ranks and reads what they wrote. The workers import
nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(module: str, argv: list, world: int, cpu: bool, timeout: Optional[float] = None,
          backend: Optional[str] = None) -> int:
    """Run ``python -m module *argv`` as ``world`` ranks on this host; returns
    0 when every rank exits 0, else the first failing rank's code (124 when
    ``timeout`` seconds pass), after stopping the others. ``backend`` sets
    ``MDE_DIST_BACKEND`` for the ranks (else they inherit it). Called on the
    main thread, it passes a SIGTERM or SIGINT it receives on to the ranks
    and goes on waiting for them."""
    port = free_port()
    env = dict(os.environ)
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "MDE_DIST_CPU"):
        env.pop(name, None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    env.update(MDE_DIST_COORDINATOR=f"127.0.0.1:{port}", MDE_DIST_NUM_PROCESSES=str(world))
    if cpu:
        env["MDE_DIST_CPU"] = "1"
    if backend:
        env["MDE_DIST_BACKEND"] = backend
    procs = []

    def forward(signum, frame):
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signum)

    handled = (signal.SIGTERM, signal.SIGINT)
    previous = ({s: signal.signal(s, forward) for s in handled}
                if threading.current_thread() is threading.main_thread() else {})
    try:
        for p in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv],
                env={**env, "MDE_DIST_PROCESS_ID": str(p), "LOCAL_RANK": str(p)}))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [proc.poll() for proc in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                return 124
            time.sleep(0.1)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


# ---------------------------------------------------------------------------
# A checked data-parallel run
# ---------------------------------------------------------------------------


def given_pipeline(rgb, depth, generator=None, plain=False, rows=None):
    """A train pipeline that passes its inputs through: the batches are
    already normalised (B, 3, H, W) float32 and resized depth."""
    del generator, plain, rows
    return rgb, depth


@contextlib.contextmanager
def train_pipeline(pipeline):
    """Within the block, ``make_train_step`` builds its step on ``pipeline``
    (``make_train_pipeline``'s signature) in place of the config's: the
    ``given`` and ``float64`` jobs below, and the one-process runs they are
    held against."""
    from ..train import trainer

    saved = trainer.make_train_pipeline
    trainer.make_train_pipeline = lambda augmentation, input_size: pipeline
    try:
        yield
    finally:
        trainer.make_train_pipeline = saved


def float64_pipeline(pipeline):
    """``pipeline`` with its outputs in float64, for a float64 model. The
    float32 flagship's trajectory is chaotic after one AdamW step (its first
    update is lr * sign(g), and a gradient whose sign is rounding noise flips
    it): two summation orders of one process give second-step losses 3%
    apart. Several steps of two summation orders are compared in float64."""
    def run(*args, **kwargs):
        return tuple(t.double() for t in pipeline(*args, **kwargs))

    return run


def run(spec: dict, spec_path: str, timeout: Optional[float] = None,
        backend: Optional[str] = None) -> dict:
    """Write ``spec`` to ``spec_path``, run its ``world`` ranks (over
    ``backend``: by default NCCL on cards, gloo on the CPU), and return what
    each rank wrote for each job: {job name: [rank 0's, rank 1's, ...]}.
    Raises if any rank fails."""
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    rc = spawn("mde_tpu_torch.parallel.launch", [spec_path], int(spec["world"]),
               cpu=spec["device"] == "cpu", timeout=timeout, backend=backend)
    if rc:
        raise RuntimeError(f"a rank of {spec_path} exited with {rc}")
    return {job["name"]: [torch.load(os.path.join(spec["out"], f"{job['name']}_rank{p}.pt"),
                                     weights_only=False) for p in range(int(spec["world"]))]
            for job in spec["jobs"]}


def _config(job: dict):
    from ..core import config as config_lib
    from ..tools.common import apply_sets

    return apply_sets(config_lib.defaults(), job.get("sets", []))


def _batchnorm_job(job: dict, device, rank: int, world: int) -> dict:
    """The cross-process BatchNorm on this rank's data index's rows of
    ``input`` (x, dy, and the layer's state_dict): its output, input
    gradient, its share of the parameters' gradients (``grads``; a
    BatchNorm2d's weight and bias also as ``dw`` and ``db``), and the state
    after. ``layer``: "batchnorm2d" (the default), or "linear_bn" (LeViT's
    Linear + BatchNorm1d over (B, N, C) tokens, made cross-process by
    ``data_parallel``'s conversion). ``over_world``: the statistics over
    every rank in place of the data group (what a model axis must not do)."""
    from . import sync_batchnorm
    from .distributed import data_count, data_index, local_row_block
    from .sync_batchnorm import convert_sync_batchnorm

    data = torch.load(job["input"], weights_only=True)
    state = data["state_dict"]
    if job.get("layer") == "linear_bn":
        from ..nn.levit import LinearBN

        layer = LinearBN(state["c.weight"].shape[1], state["c.weight"].shape[0])
    else:
        layer = torch.nn.BatchNorm2d(data["x"].shape[1])
    # the parameters in their own type: float32 beside a bf16 input, as autocast runs it
    layer = layer.to(state["bn.weight" if "bn.weight" in state else "weight"].dtype)
    layer.load_state_dict(state)
    convert_sync_batchnorm(layer).to(device).train()
    lo, hi = local_row_block(data["x"].shape[0], data_index(), data_count())
    x = data["x"][lo:hi].to(device).requires_grad_(True)
    group = sync_batchnorm.data_group
    if job.get("over_world"):
        sync_batchnorm.data_group = lambda: None
    try:
        y = layer(x)
        y.backward(data["dy"][lo:hi].to(device))
    finally:
        sync_batchnorm.data_group = group
    grads = {k: p.grad.cpu() for k, p in layer.named_parameters()}
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(), "dw": grads.get("weight"),
            "db": grads.get("bias"), "grads": grads,
            "state_dict": {k: v.cpu() for k, v in layer.state_dict().items()}}


def _mlp_job(job: dict, device, rank: int, world: int) -> dict:
    """The Megatron layers against their one-process Linears: ``input`` holds
    a ViT ``Mlp``'s state_dict, x and dy. The MLP goes through
    ``tensor_parallel`` (fc1 column-, fc2 row-parallel); records its output,
    the input gradient, fc1's output gathered by ``gather_from_model`` and
    the parameters' gradients gathered to the full shapes."""
    from ..nn.vit import Mlp
    from .distributed import model_count
    from .tensor import full_state_dict, gather_from_model, tensor_parallel

    data = torch.load(job["input"], weights_only=True)
    state = data["state_dict"]
    mlp = Mlp(*state["fc1.weight"].shape[::-1]).to(state["fc1.weight"].dtype)
    mlp.load_state_dict(state)
    tensor_parallel(mlp.to(device), model_count())
    x = data["x"].to(device).requires_grad_(True)
    y = mlp(x)
    y.backward(data["dy"].to(device))
    grads = full_state_dict(mlp, {n: p.grad for n, p in mlp.named_parameters()})
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(),
            "fc1": gather_from_model(mlp.fc1(x)).detach().cpu(),
            "grads": {k: v.cpu() for k, v in grads.items()},
            "shapes": {k: tuple(v.shape) for k, v in mlp.state_dict().items()}}


def _tensor_parallel(model, device):
    """``model`` on ``device``, through ``tensor_parallel`` at the job's T;
    returns it with the bytes of its parameters (whole, and a rank's as the
    layout predicts them) and the layout's sharded keys."""
    from .distributed import model_count
    from .mesh import tp_layout
    from .tensor import predicted_parameter_bytes, tensor_parallel

    size = model_count()
    layout = tp_layout(model, size)
    predicted = {"whole": predicted_parameter_bytes(model, {}, 1),
                 "rank": predicted_parameter_bytes(model, layout, size)}
    if size > 1:
        tensor_parallel(model, size)
    return model.to(device), predicted, sorted(k for k, v in layout.items() if v != "replicated")


def _steps_job(job: dict, device, rank: int, world: int) -> dict:
    """Train steps on this rank's data index's ``local_rows`` of each global
    batch, over the job's model axis."""
    from ..data.transforms import make_train_pipeline
    from ..ops import kernels
    from ..train.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded
    from ..train.trainer import make_optimizer, make_train_step, step_generator
    from .distributed import data_count, data_index
    from .mesh import data_parallel, local_rows
    from .tensor import full_optimizer_state, full_state_dict, parameter_bytes

    cfg = _config(job)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = torch.load(job["model"], weights_only=False)
    pipeline = given_pipeline if job.get("given") else make_train_pipeline(
        bool(cfg.augmentation), cfg.framework.input_size)
    if job.get("float64"):
        model, pipeline = model.double(), float64_pipeline(pipeline)
    model, predicted, sharded = _tensor_parallel(model, device)
    optimizer = make_optimizer(model, cfg)
    restored = None
    if job.get("restore"):
        load_checkpoint_sharded(job["restore"], model, optimizer)
        # copies: the steps below update the live tensors in place
        restored = {"state_dict": {k: v.cpu().clone() for k, v in full_state_dict(model).items()},
                    "optimizer": copy.deepcopy(full_optimizer_state(model, optimizer))}
    trained = data_parallel(model, device) if torch.distributed.is_initialized() else model
    accum = int(job.get("accum", 1))
    with train_pipeline(pipeline):
        step = make_train_step(trained, cfg, optimizer, accum_steps=accum,
                               plain=bool(job.get("plain")))
    losses, ms, launches = [], [], []
    for batch, gen in zip(torch.load(job["batches"], weights_only=False), job["generators"]):
        rows = local_rows(len(batch["rgb"]), accum, data_index(), data_count())
        rgb, depth = (torch.as_tensor(np.asarray(batch[k])[slice(None) if rows is None else rows])
                      .to(device) for k in ("rgb", "depth"))
        before = kernels.launch_counts()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        metrics = step(rgb, depth, step_generator(*gen), replicated=rows is None)
        losses.append({k: v.item() for k, v in metrics.items()})
        ms.append((time.perf_counter() - t0) * 1e3)
        after = kernels.launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
    if job.get("save_sharded"):
        save_checkpoint_sharded(job["save_sharded"], model, optimizer, steps=len(losses))
    state = full_state_dict(model)  # the full grammar: gathered over the model group
    grads = (full_state_dict(model, {n: p.grad for n, p in model.named_parameters()
                                     if p.grad is not None}) if job.get("grads") else None)
    optimizer_state = full_optimizer_state(model, optimizer) if job.get("restore") else None
    out = {"losses": losses, "step_ms": ms, "launches": launches,
           "fingerprint": {k: v.double().norm().item() for k, v in state.items()},
           "param_bytes": parameter_bytes(model), "param_bytes_predicted": predicted["rank"],
           "param_bytes_whole": predicted["whole"],
           "sharded_keys": sharded}
    if device.type == "cuda":
        out["peak_mib"] = {"allocated": torch.cuda.max_memory_allocated(device) / 2**20,
                           "reserved": torch.cuda.max_memory_reserved(device) / 2**20}
    if rank == 0:  # float32, without the frozen parameters (no gradient)
        keep = set(state) - {n for n, p in model.named_parameters() if not p.requires_grad}
        out["state_dict"] = {k: v.detach().cpu().float() if v.is_floating_point() else v.cpu()
                             for k, v in state.items() if k in keep}
        if grads is not None:
            out["grads"] = {k: v.cpu() for k, v in grads.items()}
        if restored is not None:
            out["restored"] = {"state_dict": {k: v.cpu() for k, v in
                                              restored["state_dict"].items()},
                               "optimizer": restored["optimizer"],
                               "optimizer_after": optimizer_state}
    return out


def _fit_job(job: dict, device, rank: int, world: int) -> dict:
    """``build_loaders``, ``fit`` and ``generate_test_predictions`` as the
    training CLI runs them, on the config's data and paths; then
    ``evaluate`` and ``evaluate_full_suite`` on fresh train (sharded) and
    val loaders."""
    from ..tools.common import build_loaders, resolve_paths
    from ..train.trainer import (evaluate, evaluate_full_suite, fit, generate_test_predictions,
                                 make_optimizer)
    from .mesh import data_parallel

    cfg = _config(job)
    model = _tensor_parallel(torch.load(job["model"], weights_only=False), device)[0]
    optimizer = make_optimizer(model, cfg)
    trained = data_parallel(model, device) if torch.distributed.is_initialized() else model
    paths = resolve_paths(cfg)
    loaders = build_loaders(cfg, paths, train=True, device=device)
    history = fit(trained, cfg, optimizer, loaders["train"], loaders["val"],
                  paths["results_dir"], seed=int(cfg.framework.seed))
    written = generate_test_predictions(trained, cfg, loaders["test"], paths["predictions_dir"])
    fresh = build_loaders(cfg, paths, train=True, device=device)
    return {"history": history, "written": written,
            "evaluate": evaluate(trained, cfg, fresh["train"]),
            "suite": {split: evaluate_full_suite(trained, cfg, fresh[split])
                      for split in ("train", "val")}}


JOBS = {"batchnorm": _batchnorm_job, "mlp": _mlp_job, "steps": _steps_job, "fit": _fit_job}


def run_rank(spec: dict) -> None:
    """One rank of a checked run, in a process the ``MDE_DIST_*`` variables
    place. ``spec``: ``world``, ``device`` (``cpu``, ``cuda`` or ``cuda:N``),
    ``out`` (a directory), and ``jobs``, each a dict with its ``name`` and
    ``mode``, and ``model_axis``, its T (default 1;
    ``distributed.set_model_axis`` splits the world into (data, model) for
    the job):

    - ``batchnorm``: ``input``, a file of x, dy and the layer's state_dict,
      ``layer`` ("batchnorm2d" or "linear_bn") and ``over_world``;
    - ``mlp``: ``input``, a file of a ViT ``Mlp``'s state_dict, x and dy;
    - ``steps``: ``model`` (a pickled module this program saved), ``sets``
      (``--set`` overrides of the default config), ``batches`` (a file of
      global batches, dicts of ``rgb``/``depth`` arrays: uint8 and raw
      depth, or with ``given`` already through the pipeline), ``accum``,
      ``generators`` ((seed, epoch, iteration) a step), ``float64`` (the
      model and the pipeline's outputs), ``plain`` (the kernels' plain
      versions, which a float64 model on a card needs), ``grads``,
      ``restore`` (a sharded checkpoint's directory, restored before the
      steps) and ``save_sharded`` (a directory, written after them);
      records the losses, each step's ms and kernel launches, each tensor's
      norm after the steps (of the full grammar, gathered over the model
      group), the bytes of the parameters the rank holds beside the
      layout's prediction, the sharded keys, on a card the job's peak
      allocated and reserved MiB, and (rank 0) the state_dict in
      float32, less the frozen parameters, with ``grads`` the last step's
      gradients gathered, and with ``restore`` the state and the optimizer's
      state right after the restore and after the steps;
    - ``fit``: ``model`` and ``sets`` (with the data and result paths);
      records the history, the predictions written and the metrics.

    Each rank writes ``<out>/<name>_rank<p>.pt`` a job, with its backend and
    device beside what the job returned.
    """
    from ..tools.common import set_float32_precision
    from . import distributed

    set_float32_precision()  # float32 with TF32 off, as the training CLI
    torch.set_num_threads(int(spec.get("threads", 2)))
    distributed.initialize_from_env(spec["device"])
    rank, world = distributed.process_index(), distributed.process_count()
    device = distributed.rank_device(spec["device"])
    backend = torch.distributed.get_backend() if torch.distributed.is_initialized() else None
    try:
        for job in spec["jobs"]:
            distributed.set_model_axis(int(job.get("model_axis", 1)))
            out = {"rank": rank, "world": world, "device": str(device), "backend": backend,
                   "data_index": distributed.data_index(),
                   "model_index": distributed.model_index(),
                   **JOBS[job["mode"]](job, device, rank, world)}
            torch.save(out, os.path.join(spec["out"], f"{job['name']}_rank{rank}.pt"))
            if device.type == "cuda":  # the next job's model gets this one's cached blocks
                torch.cuda.empty_cache()
            distributed.barrier(job["name"])
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        run_rank(json.load(f))

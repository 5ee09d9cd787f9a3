"""Shared plumbing for the entry points (port of mde_tpu/tools/common.py):
config resolution, path layout, loaders, model bootstrapping.

There is no compilation cache to set up: PyTorch runs eagerly. A process
started by a launcher (torchrun, the ``MDE_DIST_*`` variables, or a tool's
own spawn) joins its process group in ``parse_config``
(``parallel.distributed.initialize_from_env``); ``enter_world`` starts or
joins the (data, model) world a tool runs over, ``bootstrap_world_model``
gives a rank its share of the model, and ``build_loaders`` gives it its
rows of every batch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple, Optional

import torch

from ..core import config as config_lib
from ..data.dataset import DepthDataset, split_train_val
from ..data.loader import HostLoader
from ..models.factory import build_model
from ..models.model_loader import DEFAULT_MODELS
from ..parallel import distributed, launch
from ..parallel.mesh import mesh_world
from ..parallel.tensor import tensor_parallel
from ..train.checkpoint import load_checkpoint


def set_float32_precision() -> None:
    """Full float32 in cuDNN's convolutions and in matmuls (TF32 off for
    both): the tools run float32 throughout, like the JAX predict step;
    torch's default would run float32 convolutions in TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def set_deterministic_convolutions() -> None:
    """cuDNN's deterministic algorithms only: the flagship's transposed
    convolution (``cross_attention.spatial_upsample``) otherwise takes one
    that sums in a different order from run to run, so that evaluating one
    checkpoint twice could print other metrics. The evaluation, prediction
    and visualisation tools call it; serving and training keep cuDNN's
    default."""
    torch.backends.cudnn.deterministic = True


def _override(cfg, item: str) -> None:
    """Apply one ``--set dotted.key=value``; the value is read as JSON when it
    parses (numbers, booleans, null, lists), else kept as a string."""
    key, sep, raw = item.partition("=")
    if not sep or not key:
        raise SystemExit(f"--set takes KEY=VALUE, got {item!r}")
    try:
        value = json.loads(raw)
    except ValueError:
        value = raw
    for part in reversed(key.split(".")):
        value = {part: value}
    cfg.merge_from(value)


def apply_sets(cfg, sets):
    """``cfg`` with each ``KEY=VALUE`` of ``sets`` applied, in order; a loader
    DPT row's input size (``loader_input_size``) then becomes
    ``framework.input_size`` unless one of ``sets`` names that key."""
    for item in sets:
        _override(cfg, item)
    size = loader_input_size(cfg)
    if size is not None and not any(s.split("=", 1)[0] == "framework.input_size"
                                    for s in sets):
        cfg.framework.input_size = list(size)
    return cfg


def parse_config(description: str, extra=None, argv=None):
    """Parse --config (YAML; the built-in flagship defaults when omitted),
    --device, --data-dir and any number of --set KEY=VALUE overrides, plus
    whatever ``extra(parser)`` adds. ``argv`` defaults to ``sys.argv[1:]``.
    Joins the process group a launcher's environment describes."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", default=None,
                   help="path to config.yaml (default: the built-in flagship config)")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--data-dir", default=None, help="override paths.data_dir")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override one config entry, e.g. training.n_epoch=2 (repeatable)")
    if extra:
        extra(p)
    args = p.parse_args(argv)
    cfg = config_lib.load(args.config) if args.config else config_lib.defaults()
    if args.data_dir:
        cfg.paths.data_dir = args.data_dir
    apply_sets(cfg, args.set)
    if os.environ.get("MDE_DIST_CPU"):
        args.device = "cpu"  # every process of the run on the CPU, over gloo
    distributed.initialize_from_env(args.device)
    return cfg, args


def tool_device(name: str) -> torch.device:
    """The ``--device`` of an entry point; ``cuda`` without a visible card
    exits rather than running on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is visible")
    return device


class World(NamedTuple):
    """This rank's card and the (data, model) world it runs in."""
    device: torch.device
    data: int
    model: int


def enter_world(cfg, args, module: str, argv=None,
                batch_size: Optional[int] = None) -> Optional[World]:
    """Start or join the (data, model) world of ``mesh_world(cfg, --device,
    batch_size)``, as the JAX tools build ``make_training_mesh(cfg,
    batch_size)``.

    One rank: this process, with no collective. More, and no launcher in
    the environment: this process starts them as ``python -m module argv``
    (``launch.spawn``; ``argv`` None is this process's own arguments), waits
    for them and returns None; it exits non-zero if one fails. A rank (under
    a launcher) splits the world into its data and model groups and gets its
    card (``rank_device``). ``--device cuda`` without a card exits."""
    device = tool_device(args.device)
    data, model = mesh_world(cfg, args.device, batch_size)
    world = data * model
    if world > 1 and not distributed.is_multiprocess():
        print(f"Starting {world} processes: (data, model) = ({data}, {model})")
        rc = launch.spawn(module, sys.argv[1:] if argv is None else argv, world,
                          cpu=device.type == "cpu")
        if rc:
            raise SystemExit(f"a rank exited with {rc}")
        return None
    distributed.set_model_axis(model)
    return World(distributed.rank_device(args.device), data, model)


def world_line(world: World) -> str:
    """", rank p of W (data i of D, model j of T; backend)", or "" in one
    process."""
    if distributed.process_count() == 1:
        return ""
    return (f", rank {distributed.process_index()} of {world.data * world.model} (data "
            f"{distributed.data_index()} of {world.data}, model {distributed.model_index()} of "
            f"{world.model}; {torch.distributed.get_backend()})")


def resolve_paths(cfg):
    data_dir = cfg.paths.data_dir
    train_list = cfg.paths.get("train_list") or os.path.join(data_dir, "train_list.txt")
    test_list = cfg.paths.get("test_list") or os.path.join(data_dir, "test_list.txt")
    return {
        "train_dir": os.path.join(data_dir, "train"),
        "test_dir": os.path.join(data_dir, "test"),
        "train_list": train_list,
        "test_list": test_list,
        "results_dir": cfg.paths.results_dir,
        "predictions_dir": cfg.paths.predictions_dir,
    }


def process_shard() -> Optional[tuple[int, int]]:
    """``HostLoader``'s ``process_shard`` of this rank: (data index, data
    count) over more than one data index, else None."""
    return ((distributed.data_index(), distributed.data_count())
            if distributed.data_count() > 1 else None)


def build_loaders(cfg, paths, train: bool = True, device=None) -> dict:
    """Train/val loaders over the 85/15 ``split_train_val`` of the train list,
    and a test loader when the test list exists; batches land on ``device``
    (pinned, non-blocking copies on a CUDA device) or stay numpy (None).
    Under W data-parallel ranks each loader yields this rank's data index's
    rows (the train loader in the layout of ``framework.grad_accum_steps``
    microbatches); the model ranks of a data index read the same rows."""
    fw = cfg.framework
    bs = int(cfg.training.batch_size)
    workers = int(fw.num_workers)
    shard = process_shard()
    loaders = {}
    if train:
        full = DepthDataset(paths["train_dir"], paths["train_list"], has_gt=True)
        tr_idx, va_idx = split_train_val(len(full), fw.val_fraction, seed=fw.seed)
        cache = bool(fw.get("cache_dataset", False))
        loaders["train"] = HostLoader(
            full, tr_idx, bs, shuffle=True, drop_last=bool(fw.drop_last), num_workers=workers,
            seed=fw.seed, prefetch_depth=int(fw.prefetch_depth), cache=cache, device=device,
            process_shard=shard, accum_steps=int(fw.get("grad_accum_steps", 1)))
        loaders["val"] = HostLoader(full, va_idx, bs, shuffle=False, num_workers=workers,
                                    cache=cache, device=device, process_shard=shard)
    if os.path.exists(paths["test_list"]):
        test_ds = DepthDataset(paths["test_dir"], paths["test_list"], has_gt=False)
        loaders["test"] = HostLoader(test_ds, batch_size=bs, num_workers=workers, device=device,
                                     process_shard=shard)
    return loaders


def live_missing_keys(model, report: dict) -> list[str]:
    """Keys a checkpoint left unset that ``model``'s forward reads: the load
    report's missing keys less BN's ``num_batches_tracked`` and the model's
    own dead keys (its class's ``DEAD_KEY_PREFIXES``)."""
    return [k for k in report["missing"] if not k.endswith("num_batches_tracked")
            and not k.startswith(model.DEAD_KEY_PREFIXES)]


def loader_input_size(cfg) -> Optional[tuple]:
    """The input (h, w) a loader DPT row named by ``model.model_type`` is
    built for (``model_loader.DEFAULT_MODELS``), or None for another model."""
    spec, size, _ = DEFAULT_MODELS.get(cfg.model.model_type, (None, None, None))
    return tuple(size) if isinstance(spec, dict) else None


def bootstrap_model(cfg, device, checkpoint: Optional[str] = None):
    """Build the model with weights from ``cfg.framework.seed``, then load
    ``checkpoint`` when it exists, and move it to ``device`` (no default:
    every caller names one). Returns (model, load report or None). A loader
    DPT row raises unless ``framework.input_size`` is the size it is built
    for."""
    size = loader_input_size(cfg)
    if size is not None and tuple(int(s) for s in cfg.framework.input_size) != size:
        raise ValueError(f"model.model_type={cfg.model.model_type} is built for "
                         f"{list(size)}, framework.input_size is "
                         f"{list(cfg.framework.input_size)}")
    gen = torch.Generator().manual_seed(int(cfg.framework.seed))
    model = build_model(cfg.model, device="cpu", generator=gen)
    report = None
    if checkpoint is not None and os.path.exists(checkpoint):
        report = load_checkpoint(model, checkpoint)
    return model.to(device).eval(), report


def bootstrap_world_model(cfg, device, checkpoint: Optional[str] = None):
    """``bootstrap_model`` (the full checkpoint loaded into the whole model),
    then this rank's Megatron share of it (``tensor_parallel``) where the
    world's model axis is more than one rank. Returns (model, load report
    or None)."""
    model, report = bootstrap_model(cfg, device, checkpoint=checkpoint)
    if distributed.model_count() > 1:
        tensor_parallel(model, distributed.model_count())
    return model, report

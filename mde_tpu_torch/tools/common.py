"""Shared plumbing for the entry points (port of mde_tpu/tools/common.py):
config resolution, path layout, loaders, model bootstrapping.

There is no compilation cache and no multi-host runtime to set up: PyTorch
runs eagerly, and multi-process serving or training is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from ..core import config as config_lib
from ..data.dataset import DepthDataset, split_train_val
from ..data.loader import HostLoader
from ..models.factory import build_model
from ..train.checkpoint import load_checkpoint


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


def parse_config(description: str, extra=None, argv=None):
    """Parse --config (YAML; the built-in flagship defaults when omitted),
    --device, --data-dir and any number of --set KEY=VALUE overrides, plus
    whatever ``extra(parser)`` adds. ``argv`` defaults to ``sys.argv[1:]``."""
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
    for item in args.set:
        _override(cfg, item)
    return cfg, args


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


def build_loaders(cfg, paths, train: bool = True, device=None) -> dict:
    """Train/val loaders over the 85/15 ``split_train_val`` of the train list,
    and a test loader when the test list exists; batches land on ``device``
    (pinned, non-blocking copies on a CUDA device) or stay numpy (None)."""
    fw = cfg.framework
    bs = int(cfg.training.batch_size)
    workers = int(fw.num_workers)
    loaders = {}
    if train:
        full = DepthDataset(paths["train_dir"], paths["train_list"], has_gt=True)
        tr_idx, va_idx = split_train_val(len(full), fw.val_fraction, seed=fw.seed)
        cache = bool(fw.get("cache_dataset", False))
        loaders["train"] = HostLoader(
            full, tr_idx, bs, shuffle=True, drop_last=bool(fw.drop_last), num_workers=workers,
            seed=fw.seed, prefetch_depth=int(fw.prefetch_depth), cache=cache, device=device)
        loaders["val"] = HostLoader(full, va_idx, bs, shuffle=False, num_workers=workers,
                                    cache=cache, device=device)
    if os.path.exists(paths["test_list"]):
        test_ds = DepthDataset(paths["test_dir"], paths["test_list"], has_gt=False)
        loaders["test"] = HostLoader(test_ds, batch_size=bs, num_workers=workers, device=device)
    return loaders


def live_missing_keys(model, report: dict) -> list[str]:
    """Keys a checkpoint left unset that ``model``'s forward reads: the load
    report's missing keys less BN's ``num_batches_tracked`` and the model's
    own dead keys (its class's ``DEAD_KEY_PREFIXES``)."""
    return [k for k in report["missing"] if not k.endswith("num_batches_tracked")
            and not k.startswith(model.DEAD_KEY_PREFIXES)]


def bootstrap_model(cfg, device="cpu", checkpoint: Optional[str] = None):
    """Build the model with weights from ``cfg.framework.seed``, then load
    ``checkpoint`` when it exists. Returns (model, load report or None)."""
    gen = torch.Generator().manual_seed(int(cfg.framework.seed))
    model = build_model(cfg.model, device="cpu", generator=gen)
    report = None
    if checkpoint is not None and os.path.exists(checkpoint):
        report = load_checkpoint(model, checkpoint)
    return model.to(device).eval(), report

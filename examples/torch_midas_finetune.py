"""MiDaS fine-tune walkthrough on the PyTorch port (port of
examples/midas_finetune.py), the midas.ipynb equivalent.

The reference's second notebook loads MiDaS_small from torch.hub, wraps it in
nn.DataParallel and fine-tunes with the scale-invariant loss at 448x576
(midas.ipynb cells 19-21). Here: MidasNetSmall, optionally warm-started from
a local .pth in the reference grammar (no download), SI loss, AdamW, through
the port's ``fit`` as the training CLI (tools/main.py) runs it. Data parallel
over the visible cards as the training CLI runs it: W =
``framework.mesh.data`` (-1: every card) clamped to divide the batch; with
W > 1 this script starts W processes of itself (``parallel.launch.spawn``),
each under DistributedDataParallel on its rows of every batch.

Usage:  python examples/torch_midas_finetune.py [--data-dir data] [--epochs 1]
        [--device cuda] [--pretrained-pth midas_v21_small_256.pt]
"""

from __future__ import annotations

import os as _os
import sys as _sys

# run from anywhere: the repository root on the path, as the JAX examples do
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import sys
import tempfile

import torch

from mde_tpu_torch.core import config as config_lib
from mde_tpu_torch.data import synthetic
from mde_tpu_torch.models.factory import build_module
from mde_tpu_torch.models.midas_small import MidasNetSmall
from mde_tpu_torch.parallel import distributed, launch
from mde_tpu_torch.parallel.mesh import data_parallel, data_world
from mde_tpu_torch.tools.common import (build_loaders, resolve_paths, set_float32_precision,
                                        tool_device)
from mde_tpu_torch.train.checkpoint import load_checkpoint
from mde_tpu_torch.train.logging import ExperimentLogger
from mde_tpu_torch.train.trainer import fit, make_optimizer

INPUT_SIZE = (448, 576)  # multiples of 32 (and of 14 for the semantics variant)
SYNTH = {"n_train": 32, "n_test": 8, "size": (426, 560)}  # the generated dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default=None)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--pretrained-pth", default=None,
                   help="optional local midas_v21_small_256.pt to warm-start from")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    distributed.initialize_from_env(args.device)  # a rank this script started joins here
    set_float32_precision()  # TF32 off, as the training CLI
    device = tool_device(args.device)

    data_dir = args.data_dir
    if data_dir is None:
        data_dir = tempfile.mkdtemp(prefix="cil_synth_")
        print(f"No --data-dir given; generating synthetic data in {data_dir}")
        synthetic.generate(data_dir, **SYNTH)

    cfg = config_lib.defaults()
    cfg.experiment.model_name = "midas_finetune"
    cfg.model.model_type = "MiDaS_small"
    cfg.model.dinov2_type = None
    cfg.framework.input_size = list(INPUT_SIZE)
    cfg.training.batch_size = args.batch_size
    cfg.training.n_epoch = args.epochs
    # pure SI loss, as midas.ipynb cell 19
    cfg.model.loss_function.si_loss_alpha = 1
    cfg.model.loss_function.grad_loss_alpha = 0
    cfg.model.loss_function.edge_loss_alpha = 0
    cfg.paths.data_dir = data_dir
    cfg.paths.results_dir = "results"

    world = data_world(cfg, args.device)
    if world > 1 and not distributed.is_multiprocess():
        print(f"Starting {world} data-parallel processes")
        rc = launch.spawn("examples.torch_midas_finetune", argv + ["--data-dir", data_dir],
                          world, cpu=device.type == "cpu")
        if rc:
            raise SystemExit(f"a data-parallel process exited with {rc}")
        return None
    device = distributed.rank_device(args.device)

    loaders = build_loaders(cfg, resolve_paths(cfg), train=True, device=device)
    model = build_module(MidasNetSmall, {}, "cpu", torch.Generator().manual_seed(0))
    if args.pretrained_pth and os.path.exists(args.pretrained_pth):
        report = load_checkpoint(model, args.pretrained_pth)
        print(f"Warm start: loaded {report['loaded']} tensors from {args.pretrained_pth}")
    model = model.to(device)

    optimizer = make_optimizer(model, cfg)
    logger = ExperimentLogger(name="midas_finetune", disabled=not distributed.is_primary(),
                              log_dir="results")
    trained = data_parallel(model, device) if world > 1 else model
    history = fit(trained, cfg, optimizer, loaders["train"], loaders["val"], "results",
                  logger=logger, seed=int(cfg.framework.seed))
    print("val losses per epoch:", [round(v, 4) for v in history["val_loss"]])
    return history


if __name__ == "__main__":
    main()

"""Depth-Anything-V2-small fine-tune recipe on the PyTorch port, end to end
(port of examples/da2_finetune.py).

Fine-tune DepthAnythingV2(size='vits') on CIL-geometry data through the
port's ``fit`` as the training CLI (tools/main.py) runs it, then write the
426x560 ``.npy`` predictions and encode the Kaggle ``predictions.csv``
(tools/create_prediction_csv.py, byte for byte the reference's).

DA-V2 is a DINOv2 trunk + DPT head (models/depth_anything.py); inputs must be
/14-divisible, so the recipe trains at 448x588 (14*32 x 14*42, the closest
/14 grid >= the reference's 448x576 training size) and resizes predictions
back to the native 426x560 as src/util.py:305-322 does. Weights train from
seed 0 unless --pretrained-pth points at a local DA-V2 checkpoint in the
release grammar (no download); the metric head (--max-depth) clamps with
sigmoid*max. Data parallel over the visible cards as the training CLI runs
it (examples/torch_midas_finetune.py says how).

Usage:  python examples/torch_da2_finetune.py [--data-dir data] [--epochs 2]
        [--device cuda]
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
from mde_tpu_torch.models.depth_anything import DepthAnythingV2
from mde_tpu_torch.models.factory import build_module
from mde_tpu_torch.parallel import distributed, launch
from mde_tpu_torch.parallel.mesh import data_parallel, data_world
from mde_tpu_torch.tools.common import (build_loaders, resolve_paths, set_float32_precision,
                                        tool_device)
from mde_tpu_torch.tools.create_prediction_csv import process_depth_maps
from mde_tpu_torch.train.checkpoint import load_checkpoint
from mde_tpu_torch.train.logging import ExperimentLogger
from mde_tpu_torch.train.trainer import fit, generate_test_predictions, make_optimizer

INPUT_SIZE = (448, 588)  # /14-divisible (DINOv2 trunk), nearest >= 448x576
SYNTH = {"n_train": 32, "n_test": 8, "size": (426, 560)}  # the generated dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default=None)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-depth", type=float, default=10.0,
                   help="metric-depth clamp (sigmoid*max); CIL depths are <10m")
    p.add_argument("--pretrained-pth", default=None,
                   help="optional local DA-V2 checkpoint in the release grammar")
    p.add_argument("--results-dir", default="results")
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
    cfg.experiment.model_name = "da2_finetune"
    cfg.framework.input_size = list(INPUT_SIZE)
    cfg.training.batch_size = args.batch_size
    cfg.training.n_epoch = args.epochs
    # pure SI loss (the reference's flagship loss config, config.yaml:34-42)
    cfg.model.loss_function.si_loss_alpha = 1
    cfg.model.loss_function.grad_loss_alpha = 0
    cfg.model.loss_function.edge_loss_alpha = 0
    cfg.paths.data_dir = data_dir
    cfg.paths.results_dir = args.results_dir

    world = data_world(cfg, args.device)
    if world > 1 and not distributed.is_multiprocess():
        print(f"Starting {world} data-parallel processes")
        rc = launch.spawn("examples.torch_da2_finetune", argv + ["--data-dir", data_dir],
                          world, cpu=device.type == "cpu")
        if rc:
            raise SystemExit(f"a data-parallel process exited with {rc}")
        return None
    device = distributed.rank_device(args.device)

    paths = resolve_paths(cfg)
    loaders = build_loaders(cfg, paths, train=True, device=device)
    model = build_module(DepthAnythingV2, {"size": "vits", "max_depth": args.max_depth}, "cpu",
                         torch.Generator().manual_seed(0))
    if args.pretrained_pth and os.path.exists(args.pretrained_pth):
        report = load_checkpoint(model, args.pretrained_pth)
        print(f"Warm start: loaded {report['loaded']} tensors")
    model = model.to(device)

    optimizer = make_optimizer(model, cfg)
    logger = ExperimentLogger(name="da2_finetune", disabled=not distributed.is_primary(),
                              log_dir=args.results_dir)
    trained = data_parallel(model, device) if world > 1 else model
    history = fit(trained, cfg, optimizer, loaders["train"], loaders["val"], args.results_dir,
                  logger=logger, seed=int(cfg.framework.seed))
    print("val losses per epoch:", [round(v, 4) for v in history["val_loss"]])

    # predictions + Kaggle csv (src/util.py:292-328 -> create_prediction_csv.py)
    pred_dir = os.path.join(args.results_dir, "predictions_da2")
    generate_test_predictions(model, cfg, loaders["test"], pred_dir)
    distributed.barrier("predictions_written")
    csv_path = os.path.join(args.results_dir, "predictions_da2.csv")
    if distributed.is_primary():
        process_depth_maps(pred_dir, paths["test_list"], csv_path)
        print(f"predictions: {pred_dir}  csv: {csv_path}")
    return history


if __name__ == "__main__":
    main()

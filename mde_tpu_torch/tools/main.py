"""Training entry point (port of mde_tpu/tools/main.py), the equivalent of the
reference's ``python src/main.py``.

    python -m mde_tpu_torch.tools.main [--config config.yaml] [--device cuda]
        [--data-dir DIR] [--set KEY=VALUE ...]

Same flow as the reference (src/main.py:529-711): the config (the built-in
flagship defaults without --config), train/val loaders from the 85/15 split
and a test loader, the configured model with weights from the seed (resumed
from ``best_model_{name}.pth`` with its optimizer and early-stopping state
when ``training.resume_training.resume``), AdamW, ``fit`` with early stopping,
best checkpoint and wandb-schema logging, the optional 7-metric evaluation,
then the 426x560 test predictions. ``--device cuda`` without a card fails
rather than training on the CPU.

The world is the JAX tool's ('data', 'model') mesh (``parallel.mesh.
mesh_world``, entered through ``common.enter_world``): T =
``framework.mesh.model`` ranks share a model, and the data axis
``framework.mesh.data`` (-1: every usable card, the visible cards over T) is
clamped to divide ``training.batch_size``. With more than one rank and no
launcher in the environment, the tool starts data x T processes of itself, one a card over NCCL (gloo on the CPU, or where
``MDE_DIST_BACKEND=gloo`` names it, as for ranks that share one named card
``--device cuda:N``), waits for them and exits non-zero if any fails. Under
torchrun or the ``MDE_DIST_*`` variables each process joins instead. Rank p
is data index p // T and model index p % T. At T > 1 each rank holds a
Megatron share of every layer ``tp_param_spec`` shards
(``parallel.tensor.tensor_parallel``: the ViT, DINOv2, BEiT, Swin V1/V2 and
Next-ViT attention, with BEiT's and Swin's per-head tables, and MLP; the
flagship's cross-attention); a model the rule leaves whole (the CNNs,
LeViT) runs replicated on the model ranks. The loader's DPTs train from
``--set model.model_type=<row>`` (``dpt_swin2_tiny_256`` ...), and the
config takes the row's input size as ``framework.input_size``. Each rank trains under
``DistributedDataParallel`` over its data group with the cross-process
BatchNorm on its data index's rows of every batch; rank 0 alone logs and
writes the checkpoint, the full reference grammar gathered from the model
ranks, which loads into one process.
"""

from __future__ import annotations

import os
import time

import torch

from ..parallel import distributed
from ..parallel.mesh import data_parallel
from ..train.checkpoint import (checkpoint_path, load_optimizer_state, load_state_dict,
                                load_training_checkpoint)
from ..train.logging import ExperimentLogger
from ..train.trainer import evaluate_full_suite, fit, generate_test_predictions, make_optimizer
from .common import (bootstrap_world_model, build_loaders, enter_world, parse_config,
                     resolve_paths, set_float32_precision, world_line)


def main(argv=None) -> dict | None:
    """Run the training flow; returns ``fit``'s history (None in the process
    that started the ranks of a data-parallel run)."""
    cfg, args = parse_config("Train a depth model (PyTorch port)", argv=argv)
    set_float32_precision()
    world = enter_world(cfg, args, "mde_tpu_torch.tools.main", argv)
    if world is None:
        return None  # the ranks ran in their own processes
    device = world.device
    paths = resolve_paths(cfg)
    os.makedirs(paths["results_dir"], exist_ok=True)
    os.makedirs(paths["predictions_dir"], exist_ok=True)

    current_time = time.strftime("%Y%m%d-%H%M%S")
    resume = bool(cfg.training.resume_training.resume)
    logger = ExperimentLogger(
        project="MonocularDepthEstimation",
        name=f"{cfg.experiment.model_name}_{current_time}",
        run_id=cfg.training.resume_training.get("run_id") if resume else None,
        resume=resume,
        config={
            "epochs": cfg.training.n_epoch,
            "batch_size": cfg.training.batch_size,
            "learning_rate": cfg.framework.learning_rate,
            "model_name": cfg.experiment.model_name,
            "run_time": current_time,
            "resume_training": resume,
            "early_stopping": {
                "patience": cfg.training.early_stopping.patience,
                "min_delta": cfg.training.early_stopping.min_delta,
            },
        },
        disabled=bool(cfg.experiment.wandb_disable) or not distributed.is_primary(),
        log_dir=paths["results_dir"],
    )
    print(f"Device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
          + world_line(world))

    loaders = build_loaders(cfg, paths, train=True, device=device)
    print(f"Train size: {loaders['train'].num_samples}, "
          f"Validation size: {loaders['val'].num_samples}")

    model, _ = bootstrap_world_model(cfg, device)
    optimizer = make_optimizer(model, cfg)
    start_epoch = int(cfg.training.resume_training.resume_from_epoch) if resume else 0
    es_state = {}
    ckpt = checkpoint_path(paths["results_dir"], cfg.experiment.model_name)
    if resume and os.path.exists(ckpt):
        # Resume the optimizer and the early-stopping state with the weights
        # (the reference saves them but never reads them back, src/main.py:98).
        payload = load_training_checkpoint(ckpt)
        load_state_dict(model, payload["model_state_dict"])
        try:
            load_optimizer_state(model, optimizer, payload["optimizer_state_dict"])
        except (KeyError, ValueError):
            print("Warning: optimizer state in checkpoint is incompatible; reinitialized.")
        es_state = {
            "best_val": float(payload.get("best_val_loss", float("inf"))),
            "best_epoch": payload.get("best_epoch"),
            "es_counter": int(payload.get("early_stopping_counter", 0)),
        }
        print(f"Resumed early-stopping state: best_val={es_state['best_val']:.4f} "
              f"(epoch {es_state['best_epoch']}), counter={es_state['es_counter']}")

    print("Starting training...")
    trained = data_parallel(model, device) if distributed.is_multiprocess() else model
    history = fit(trained, cfg, optimizer, loaders["train"], loaders["val"],
                  paths["results_dir"], logger=logger, start_epoch=start_epoch,
                  seed=int(cfg.framework.seed), **es_state)

    if bool(cfg.opt.get("evaluate_best_model", False)):
        print("Evaluating model on validation set...")
        metrics = evaluate_full_suite(model, cfg, loaders["val"])
        print("\nValidation Metrics:")
        for name, value in metrics.items():
            print(f"{name}: {value:.4f}")
        if distributed.is_primary():
            with open(os.path.join(paths["results_dir"], "validation_metrics.txt"), "w") as f:
                for name, value in metrics.items():
                    f.write(f"{name}: {value:.4f}\n")

    if "test" in loaders:
        print("Generating predictions for test set...")
        generate_test_predictions(model, cfg, loaders["test"], paths["predictions_dir"])
    distributed.barrier("predictions_written")
    print(f"Results saved to {paths['results_dir']}")
    print(f"All test depth map predictions saved to {paths['predictions_dir']}")
    return history


if __name__ == "__main__":
    main()

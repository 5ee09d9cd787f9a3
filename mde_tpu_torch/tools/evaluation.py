"""Standalone metric evaluation (port of mde_tpu/tools/evaluation.py), the
equivalent of the reference's ``python src/evaluation.py``.

    python -m mde_tpu_torch.tools.evaluation [--config config.yaml] [--device cuda]
        [--data-dir DIR] [--set KEY=VALUE ...]

The reference's protocol (src/evaluation.py:99-185): load
``best_model_{model_name}.pth``, print the trainable-parameter count, then
evaluate the first ``framework.eval_n_samples`` samples of the *train* list
(``training.batch_size``, no shuffle, no augmentation) and print the
average SI loss (square root), AbsRel and delta at ``eval_base_thres ** j``
for j in 1..``eval_n_delta``, with the excess of the last batch taken back
out. float32 with TF32 off, like the training tool, and cuDNN's
deterministic algorithms only, so that one checkpoint prints the same
numbers every time. ``--device cuda`` without a card fails rather than
running on the CPU.

The world is the JAX tool's ``make_training_mesh(cfg, training.batch_size)``
(``common.enter_world``; the training CLI's module docstring says how
``framework.mesh`` picks it): with more than one rank and no launcher, this
process starts them and waits. Each data index reads its rows of every batch
(a batch that does not split runs whole on every rank), each model group
runs its Megatron share of the model, the metrics are the global batch's on
every rank, and rank 0 alone prints.
"""

from __future__ import annotations

from typing import Optional

from ..data.dataset import DepthDataset
from ..data.loader import HostLoader
from ..parallel import distributed
from ..train.checkpoint import checkpoint_path
from ..train.trainer import evaluate, trainable_parameters
from .common import (bootstrap_world_model, enter_world, parse_config, process_shard,
                     resolve_paths, set_deterministic_convolutions, set_float32_precision)


def count_trainable_params(model) -> int:
    """The values of ``trainable_parameters`` (``requires_grad``, outside the
    frozen DINOv2), less the model's dead keys (``DEAD_KEY_PREFIXES``: the
    reference grammar's modules that the forward never reads, which the JAX
    model does not hold); the JAX tool's ``count_trainable_params``. Of a
    model rank's share (``tensor_parallel``), the whole model's count: a
    sharded parameter's values times T."""
    share = getattr(model, "tp_share", None)
    scale = {name: share.size for name, kind in share.layout.items()
             if kind != "replicated"} if share is not None else {}
    names = {id(p): name for name, p in model.named_parameters()}
    return sum(p.numel() * scale.get(names[id(p)], 1) for p in trainable_parameters(model)
               if not names[id(p)].startswith(model.DEAD_KEY_PREFIXES))


def main(argv=None) -> Optional[dict]:
    """Run the evaluation; returns the metrics (rank 0 prints them), or None
    in the process that started the ranks."""
    cfg, args = parse_config("Evaluate a depth model checkpoint (PyTorch port)", argv=argv)
    set_float32_precision()
    set_deterministic_convolutions()
    world = enter_world(cfg, args, "mde_tpu_torch.tools.evaluation", argv)
    if world is None:
        return None
    show = print if distributed.is_primary() else (lambda *a, **k: None)
    paths = resolve_paths(cfg)
    ckpt = checkpoint_path(paths["results_dir"], cfg.experiment.model_name)
    show(f"Loading model {cfg.model.model_type} from {ckpt}")
    model, _ = bootstrap_world_model(cfg, world.device, checkpoint=ckpt)
    show(f"Number of trainable parameters in the model: {count_trainable_params(model)}")

    dataset = DepthDataset(paths["train_dir"], paths["train_list"], has_gt=True)
    loader = HostLoader(dataset, batch_size=int(cfg.training.batch_size), shuffle=False,
                        num_workers=int(cfg.framework.num_workers), device=world.device,
                        process_shard=process_shard())
    metrics = evaluate(model, cfg, loader, n_samples=int(cfg.framework.eval_n_samples))

    base = float(cfg.framework.eval_base_thres)
    show(f"Average Scale-Invariant Loss: {metrics['si_rmse']}")
    show(f"Average Absolute Relative Error: {metrics['abs_rel']}")
    for j in range(1, int(cfg.framework.eval_n_delta) + 1):
        show(f"Average Delta {base**j} Threshold: {metrics[f'delta_{j}']}")
    return metrics


if __name__ == "__main__":
    main()

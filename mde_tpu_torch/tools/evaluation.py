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
"""

from __future__ import annotations

from ..data.dataset import DepthDataset
from ..data.loader import HostLoader
from ..train.checkpoint import checkpoint_path
from ..train.trainer import evaluate, trainable_parameters
from .common import (bootstrap_model, parse_config, resolve_paths,
                     set_deterministic_convolutions, set_float32_precision, tool_device)


def count_trainable_params(model) -> int:
    """The values of ``trainable_parameters`` (``requires_grad``, outside the
    frozen DINOv2), less the model's dead keys (``DEAD_KEY_PREFIXES``: the
    reference grammar's modules that the forward never reads, which the JAX
    model does not hold); the JAX tool's ``count_trainable_params``."""
    dead = {id(p) for name, p in model.named_parameters()
            if name.startswith(model.DEAD_KEY_PREFIXES)}
    return sum(p.numel() for p in trainable_parameters(model) if id(p) not in dead)


def main(argv=None) -> dict:
    """Run the evaluation; returns the metrics it printed."""
    cfg, args = parse_config("Evaluate a depth model checkpoint (PyTorch port)", argv=argv)
    set_float32_precision()
    set_deterministic_convolutions()
    device = tool_device(args.device)
    paths = resolve_paths(cfg)
    ckpt = checkpoint_path(paths["results_dir"], cfg.experiment.model_name)
    print(f"Loading model {cfg.model.model_type} from {ckpt}")
    model, _ = bootstrap_model(cfg, device, checkpoint=ckpt)
    print(f"Number of trainable parameters in the model: {count_trainable_params(model)}")

    dataset = DepthDataset(paths["train_dir"], paths["train_list"], has_gt=True)
    loader = HostLoader(dataset, batch_size=int(cfg.training.batch_size), shuffle=False,
                        num_workers=int(cfg.framework.num_workers), device=device)
    metrics = evaluate(model, cfg, loader, n_samples=int(cfg.framework.eval_n_samples))

    base = float(cfg.framework.eval_base_thres)
    print(f"Average Scale-Invariant Loss: {metrics['si_rmse']}")
    print(f"Average Absolute Relative Error: {metrics['abs_rel']}")
    for j in range(1, int(cfg.framework.eval_n_delta) + 1):
        print(f"Average Delta {base**j} Threshold: {metrics[f'delta_{j}']}")
    return metrics


if __name__ == "__main__":
    main()

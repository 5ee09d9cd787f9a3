"""Submission pipeline (port of mde_tpu/tools/generate_predictions.py), the
equivalent of the reference's ``python src/generate_predictions.py``.

    python -m mde_tpu_torch.tools.generate_predictions [--config config.yaml]
        [--device cuda] [--data-dir DIR] [--set KEY=VALUE ...]

Loads ``best_model_{model_name}.pth``, writes one native-size (426x560)
``.npy`` prediction a test image into ``paths.predictions_dir``, then
encodes ``predictions.csv`` in the current directory in the same process
(the reference shells out to create_prediction_csv.py,
src/generate_predictions.py:50). float32 with TF32 off and cuDNN's
deterministic algorithms only. ``--device cuda`` without a card fails
rather than running on the CPU.
"""

from __future__ import annotations

from ..data.dataset import DepthDataset
from ..data.loader import HostLoader
from ..train.checkpoint import checkpoint_path
from ..train.trainer import generate_test_predictions
from .common import (bootstrap_model, parse_config, resolve_paths,
                     set_deterministic_convolutions, set_float32_precision, tool_device)
from .create_prediction_csv import process_depth_maps


def main(argv=None) -> int:
    """Write the predictions and the CSV; returns the number of predictions."""
    cfg, args = parse_config("Generate test predictions + Kaggle CSV (PyTorch port)", argv=argv)
    set_float32_precision()
    set_deterministic_convolutions()
    device = tool_device(args.device)
    paths = resolve_paths(cfg)
    ckpt = checkpoint_path(paths["results_dir"], cfg.experiment.model_name)
    model, _ = bootstrap_model(cfg, device, checkpoint=ckpt)

    test_ds = DepthDataset(paths["test_dir"], paths["test_list"], has_gt=False)
    loader = HostLoader(test_ds, batch_size=int(cfg.training.batch_size),
                        num_workers=int(cfg.framework.num_workers), device=device)
    written = generate_test_predictions(model, cfg, loader, paths["predictions_dir"])
    process_depth_maps(predictions_dir=paths["predictions_dir"],
                       test_list_file=paths["test_list"], output_csv="predictions.csv")
    return written


if __name__ == "__main__":
    main()

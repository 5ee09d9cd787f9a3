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

The world is the JAX tool's ``make_training_mesh(cfg, training.batch_size)``
(``common.enter_world``): with more than one rank and no launcher, this
process starts them and waits. Each data index predicts its rows of every
batch and its model rank 0 writes them; a batch that does not split is
predicted by data index 0. After a barrier rank 0 encodes the CSV, the file
one process writes.
"""

from __future__ import annotations

from typing import Optional

from ..data.dataset import DepthDataset
from ..data.loader import HostLoader
from ..parallel import distributed
from ..train.checkpoint import checkpoint_path
from ..train.trainer import generate_test_predictions
from .common import (bootstrap_world_model, enter_world, parse_config, process_shard,
                     resolve_paths, set_deterministic_convolutions, set_float32_precision)
from .create_prediction_csv import process_depth_maps


def main(argv=None) -> Optional[int]:
    """Write the predictions and the CSV; returns the number of predictions
    this rank wrote, or None in the process that started the ranks."""
    cfg, args = parse_config("Generate test predictions + Kaggle CSV (PyTorch port)", argv=argv)
    set_float32_precision()
    set_deterministic_convolutions()
    world = enter_world(cfg, args, "mde_tpu_torch.tools.generate_predictions", argv)
    if world is None:
        return None
    paths = resolve_paths(cfg)
    ckpt = checkpoint_path(paths["results_dir"], cfg.experiment.model_name)
    model, _ = bootstrap_world_model(cfg, world.device, checkpoint=ckpt)

    test_ds = DepthDataset(paths["test_dir"], paths["test_list"], has_gt=False)
    loader = HostLoader(test_ds, batch_size=int(cfg.training.batch_size),
                        num_workers=int(cfg.framework.num_workers), device=world.device,
                        process_shard=process_shard())
    written = generate_test_predictions(model, cfg, loader, paths["predictions_dir"])
    distributed.barrier("predictions_written")
    if distributed.is_primary():
        process_depth_maps(predictions_dir=paths["predictions_dir"],
                           test_list_file=paths["test_list"], output_csv="predictions.csv")
    return written


if __name__ == "__main__":
    main()

"""Qualitative visualisation (port of mde_tpu/tools/visualize.py), the
equivalent of the reference's ``python src/visualize.py``.

    python -m mde_tpu_torch.tools.visualize [--config config.yaml] [--device cuda]
        [--data-dir DIR] [--set KEY=VALUE ...] [--n-samples 100]
        [--output-dir visualization]

Loads ``best_model_{model_name}.pth``, forwards the first ``--n-samples``
train images one at a time, and writes three PNGs a sample into
``<output-dir>/figures`` with the reference's names and colormaps
(src/visualize.py:103-151): ``{i:06d}_gtd.png`` (ground truth, plasma),
``{i:06d}_{model_name}_pred.png`` (prediction, plasma) and
``{i:06d}_{model_name}_lmap.png`` (per-pixel SI loss, hot).
``visualize_sample`` draws the reference's 2x2 grid. ``sample_maps``
computes the three arrays without drawing. matplotlib is imported only by
the functions that draw. float32 with TF32 off and cuDNN's deterministic
algorithms only. ``--device cuda`` without a card fails rather than running
on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.dataset import DepthDataset
from ..data.loader import HostLoader
from ..data.transforms import preprocess_eval
from ..losses.losses import per_pixel_scale_invariant_loss
from ..train.checkpoint import checkpoint_path
from .common import (bootstrap_model, parse_config, resolve_paths,
                     set_deterministic_convolutions, set_float32_precision, tool_device)

N_SAMPLES = 100


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def sample_maps(model, cfg, rgb_u8: torch.Tensor, depth: torch.Tensor):
    """One sample, (1, H, W, 3) uint8 and (1, H, W) depth on the model's
    device -> (prediction, ground truth, loss map), each an (H', W') float32
    numpy array at ``framework.input_size``: the eval-mode prediction, the
    depth resized with align-corners, and ``per_pixel_scale_invariant_loss``
    of the two, each floored at 1e-6 (mde_tpu/tools/visualize.py:91-104)."""
    input_size = tuple(int(s) for s in cfg.framework.input_size)
    model.eval()
    with torch.inference_mode():
        rgb, depth_gt = preprocess_eval(rgb_u8, depth, input_size=input_size)
        pred = model(rgb)[0]
        gt = depth_gt[0]
        loss_map = per_pixel_scale_invariant_loss(torch.clamp(pred, min=1e-6),
                                                  torch.clamp(gt, min=1e-6))
    return tuple(t.cpu().numpy() for t in (pred, gt, loss_map))


def visualize_sample(rgb_image, pred_depth, gt_depth, loss_map=None, save_path=None):
    """2x2 grid: RGB / loss map / GT depth / predicted depth (src/visualize.py:41-101)."""
    plt = _pyplot()
    if rgb_image.shape[0] == 3:
        rgb_image = np.transpose(rgb_image, (1, 2, 0))
    normalized = (rgb_image - rgb_image.min()) / (rgb_image.max() - rgb_image.min() + 1e-6)
    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    axes = axes.flatten()
    axes[0].imshow(normalized)
    axes[0].set_title("Input RGB Image")
    if loss_map is not None:
        im = axes[1].imshow(loss_map, cmap="hot")
        axes[1].set_title("Per-pixel Loss Map")
        plt.colorbar(im, ax=axes[1], fraction=0.046, pad=0.04)
    axes[2].imshow(gt_depth, cmap="plasma")
    axes[2].set_title("Ground Truth Depth")
    axes[3].imshow(pred_depth, cmap="plasma")
    axes[3].set_title("Predicted Depth")
    for ax in axes:
        ax.axis("off")
    plt.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        plt.savefig(save_path, bbox_inches="tight", dpi=300)
        plt.close(fig)
    else:  # pragma: no cover
        plt.show()


def save_images(pred_depth, gt_depth, index, model_name, loss_map=None, save_path="."):
    plt = _pyplot()
    plt.imsave(os.path.join(save_path, f"{index:06d}_gtd.png"), gt_depth, cmap="plasma")
    plt.imsave(
        os.path.join(save_path, f"{index:06d}_{model_name}_pred.png"), pred_depth, cmap="plasma"
    )
    if loss_map is not None:
        plt.imsave(
            os.path.join(save_path, f"{index:06d}_{model_name}_lmap.png"), loss_map, cmap="hot"
        )


def main(argv=None) -> int:
    """Write the figures; returns the number of samples drawn."""
    def extra(p):
        p.add_argument("--n-samples", type=int, default=N_SAMPLES)
        p.add_argument("--output-dir", default="visualization")

    cfg, args = parse_config("Visualize predictions + loss maps (PyTorch port)", extra, argv)
    set_float32_precision()
    set_deterministic_convolutions()
    device = tool_device(args.device)
    paths = resolve_paths(cfg)
    model_name = cfg.experiment.model_name
    ckpt = checkpoint_path(paths["results_dir"], model_name)
    print(f"Loading model {cfg.model.model_type} from {ckpt}")
    model, _ = bootstrap_model(cfg, device, checkpoint=ckpt)

    dataset = DepthDataset(paths["train_dir"], paths["train_list"], has_gt=True)
    loader = HostLoader(dataset, indices=range(min(args.n_samples, len(dataset))),
                        batch_size=1, num_workers=2, device=device)
    figures_dir = os.path.join(args.output_dir, "figures")
    os.makedirs(figures_dir, exist_ok=True)
    drawn = 0
    for i, batch in enumerate(loader):
        pred, gt, loss_map = sample_maps(model, cfg, batch["rgb"], batch["depth"])
        save_images(pred, gt, i, model_name, loss_map, figures_dir)
        drawn += 1
    print("Visualization saved to", args.output_dir)
    return drawn


if __name__ == "__main__":
    main()

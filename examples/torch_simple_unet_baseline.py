"""Course-baseline walkthrough on the PyTorch port (port of
examples/simple_unet_baseline.py).

The reference ships this flow as a 23-cell notebook: SimpleUNet (2-level
UNet, sigmoid*10 head, notebook cells 10-11) trained with MSE (cell ~15) at
the native 426x560 resolution (cell 4), AdamW lr=1e-4 wd=1e-4 batch 4, then
the validation MSE each epoch and the test predictions as native-size .npy
files. The same recipe on mde_tpu_torch, float32, on the card unless
``--device cpu``.

Usage:  python examples/torch_simple_unet_baseline.py [--data-dir data] [--epochs 1]
        [--device cuda]
(no data dir -> a small synthetic CIL-format dataset is generated)
"""

from __future__ import annotations

import os as _os
import sys as _sys

# run from anywhere: the repository root on the path, as the JAX examples do
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import tempfile
import time

import torch

from mde_tpu_torch.core import config as config_lib
from mde_tpu_torch.data import synthetic
from mde_tpu_torch.data.dataset import DepthDataset, split_train_val
from mde_tpu_torch.data.loader import HostLoader
from mde_tpu_torch.data.transforms import preprocess_eval, preprocess_train
from mde_tpu_torch.models.factory import build_module
from mde_tpu_torch.models.simple_unet import SimpleUNet
from mde_tpu_torch.tools.common import set_float32_precision, tool_device
from mde_tpu_torch.train.trainer import (generate_test_predictions, make_optimizer,
                                         step_generator)

INPUT_SIZE = (426, 560)  # notebook cell 4: trains at the native resolution
SYNTH = {"n_train": 32, "n_test": 8}  # the generated dataset, at INPUT_SIZE


def mse_loss(pred, target):
    """The notebook baseline trains with plain MSE (not scale-invariant)."""
    return torch.mean(torch.square(pred - target))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default=None)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = p.parse_args(argv)
    set_float32_precision()  # TF32 off, as the training CLI
    device = tool_device(args.device)

    data_dir = args.data_dir
    if data_dir is None:
        data_dir = tempfile.mkdtemp(prefix="cil_synth_")
        print(f"No --data-dir given; generating synthetic data in {data_dir}")
        synthetic.generate(data_dir, size=INPUT_SIZE, **SYNTH)

    cfg = config_lib.defaults()
    cfg.framework.input_size = list(INPUT_SIZE)
    cfg.framework.native_size = list(INPUT_SIZE)
    cfg.experiment.model_name = "simple_unet_baseline"
    cfg.model.model_type = "U_Net"
    cfg.training.batch_size = args.batch_size

    full = DepthDataset(os.path.join(data_dir, "train"), os.path.join(data_dir, "train_list.txt"))
    tr_idx, va_idx = split_train_val(len(full), 0.15, seed=0)
    train_loader = HostLoader(full, tr_idx, args.batch_size, shuffle=True, drop_last=True,
                              device=device)
    val_loader = HostLoader(full, va_idx, args.batch_size, device=device)

    model = build_module(SimpleUNet, {}, device, torch.Generator().manual_seed(0))
    optimizer = make_optimizer(model, cfg)

    def train_step(generator, rgb_u8, depth_raw):
        rgb, depth = preprocess_train(rgb_u8, depth_raw, input_size=INPUT_SIZE,
                                      generator=generator)
        model.train()
        loss = mse_loss(model(rgb), depth)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.inference_mode()
    def val_step(rgb_u8, depth_raw):
        rgb, depth = preprocess_eval(rgb_u8, depth_raw, input_size=INPUT_SIZE)
        model.eval()
        return mse_loss(model(rgb), depth)

    for epoch in range(args.epochs):
        t0 = time.time()
        tl, n = 0.0, 0
        for i, batch in enumerate(train_loader):
            loss = train_step(step_generator(1, epoch, i), batch["rgb"], batch["depth"])
            tl += float(loss) * batch["rgb"].shape[0]
            n += batch["rgb"].shape[0]
        vl, m = 0.0, 0
        for batch in val_loader:
            vl += float(val_step(batch["rgb"], batch["depth"])) * batch["rgb"].shape[0]
            m += batch["rgb"].shape[0]
        print(f"Epoch {epoch + 1}/{args.epochs}: train MSE {tl / max(n, 1):.4f}, "
              f"val MSE {vl / max(m, 1):.4f} ({time.time() - t0:.1f}s)")

    test_list = os.path.join(data_dir, "test_list.txt")
    if os.path.exists(test_list):
        test_ds = DepthDataset(os.path.join(data_dir, "test"), test_list, has_gt=False)
        test_loader = HostLoader(test_ds, batch_size=args.batch_size, device=device)
        out_dir = "predictions_simple_unet"
        generate_test_predictions(model, cfg, test_loader, out_dir)
        print(f"Test predictions saved to {out_dir}/")


if __name__ == "__main__":
    main()

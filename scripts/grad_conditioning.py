"""How far a float32 train step's gradient moves when its input moves by K3's
rounding, beside its distance from a float64 step: the conditioning of the
EfficientNet and ResNeXt encoders' gradients, on the CPU.

On an H100 the zoo's float32 gradient through the kernels sits 0.020
(MiDaS-small) to 0.071 (MidasNet) rel-L2 from the plain step's, and 0.358
for MidasNet at a final depth bias of +0.5, while the plain step against
itself reads 0; the kernels' inputs differ from the plain versions' only by
K3's rounding (the train form's largest gap is 4.53e-6 on values up to 2.6).
This script asks whether that is the model's conditioning or a fault: for
MiDaS-small and MidasNet from the port's factory (seed 0, final depth bias
raised by +0.5 and by +2.0, as chip_smoke.py's zoo steps), one train step's
loss and gradient (``forward_backward``: BN in training mode, the default
losses) at batch 4 on generated samples through the plain train pipeline:

- ``rounding``: float32 against the same step in float64;
- ``moved_ulp``: float32 on the same input moved by one float32 ulp at random
  signs, against float32; ``moved_k3_gap``: moved uniformly within K3's
  train form's largest gap from its plain version (4.53e-6);
- ``moved_*_vs_float64``: each moved float32 step against float64;

each as the global gradient's rel-L2 and per top-level module. Prints one
JSON line a model and bias.

    python scripts/grad_conditioning.py [--size 224 288] [--models midas midas_small]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mde_tpu_torch.core import config  # noqa: E402
from mde_tpu_torch.data import synthetic  # noqa: E402
from mde_tpu_torch.data.transforms import make_train_pipeline  # noqa: E402
from mde_tpu_torch.models import factory  # noqa: E402
from mde_tpu_torch.train.trainer import forward_backward, step_generator  # noqa: E402

# K3's train form against its plain version at the flagship's shape, the
# largest gap, on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's kernels
# phase)
K3_TRAIN_GAP = 4.53e-6
MODELS = {"midas_small": {"model_type": "MiDaS_small", "dinov2_type": None},
          "midas": {"model_type": "MiDaS", "dinov2_type": None}}


def grads(model, cfg, rgb, depth) -> tuple[float, dict]:
    model.zero_grad(set_to_none=True)
    loss, _ = forward_backward(model, cfg, rgb, depth, plain=True)
    return loss.item(), {k: p.grad.double().flatten().clone()
                         for k, p in model.named_parameters() if p.grad is not None}


def gaps(got: dict, want: dict) -> dict:
    """Global rel-L2 and per top-level module (denominator floored at 1% of
    the global norm, as chip_smoke.py's ``_grad_gaps``)."""
    keys = sorted(want)
    flat_w = torch.cat([want[k] for k in keys])
    norm = flat_w.norm().item()
    out = {"global": (torch.cat([got[k] for k in keys]) - flat_w).norm().item() / norm}
    for top in sorted({k.split(".", 1)[0] for k in keys}):
        ks = [k for k in keys if k.split(".", 1)[0] == top]
        d = torch.cat([got[k] - want[k] for k in ks]).norm().item()
        out[top] = d / max(torch.cat([want[k] for k in ks]).norm().item(), 1e-2 * norm)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=(224, 288), help="the model's input")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--models", nargs="+", choices=sorted(MODELS), default=sorted(MODELS))
    p.add_argument("--threads", type=int, default=6)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    size = tuple(args.size)
    rng = np.random.default_rng(0)
    samples = [synthetic.make_sample(rng, 426, 560) for _ in range(args.batch)]
    rgb_u8 = torch.from_numpy(np.stack([s[0] for s in samples]))
    depth_raw = torch.from_numpy(np.stack([s[1] for s in samples]))
    rgb, depth = make_train_pipeline(False, size)(rgb_u8, depth_raw,
                                                  generator=step_generator(0, 0, 0), plain=True)
    # K3's train form against its plain version: one float32 ulp at random
    # signs, and uniform within its largest gap on an H100 (K3_TRAIN_GAP)
    ulp = torch.from_numpy(np.spacing(np.abs(rgb.numpy())).astype(np.float32))
    moves = {"ulp": rgb + ulp * torch.from_numpy(
                 rng.choice([-1.0, 1.0], rgb.shape).astype(np.float32)),
             "k3_gap": rgb + torch.from_numpy(
                 rng.uniform(-K3_TRAIN_GAP, K3_TRAIN_GAP, rgb.shape).astype(np.float32))}
    for name in args.models:
        overrides = MODELS[name]
        cfg = config.defaults()
        cfg.model.model_type = overrides["model_type"]
        cfg.model.dinov2_type = overrides["dinov2_type"]
        cfg.framework.compute_dtype = "float32"
        base = factory.build_model(cfg.model, "cpu", torch.Generator().manual_seed(0))
        for bias in (0.5, 2.0):
            model = copy.deepcopy(base)
            with torch.no_grad():
                model.scratch.output_conv[4].bias.add_(bias)
            loss32, g32 = grads(copy.deepcopy(model), cfg, rgb, depth)
            loss64, g64 = grads(copy.deepcopy(model).double(), cfg, rgb.double(), depth.double())
            row = {"model": name, "bias": bias, "size": list(size), "batch": args.batch,
                   "loss": {"float32": loss32, "float64": loss64},
                   "rounding": gaps(g32, g64)}
            for move, x in moves.items():
                loss_m, g_m = grads(copy.deepcopy(model), cfg, x, depth)
                row["loss"][move] = loss_m
                row[f"moved_{move}"] = gaps(g_m, g32)
                row[f"moved_{move}_vs_float64"] = gaps(g_m, g64)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

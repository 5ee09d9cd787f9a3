"""Export the configured model and its checkpoint as an ahead-of-time serving
artifact (port of mde_tpu/tools/export_model.py).

Writes one archive (train/export.py): the best checkpoint's weights once, and
one ``torch.export`` program of the predict step per batch bucket and
platform, which ``python -m mde_tpu_torch.tools.serve --exported`` serves with
no model code and no checkpoint access.

    python -m mde_tpu_torch.tools.export_model [--config ...] [--device cuda]
        [--data-dir DIR] [--set KEY=VALUE ...] --out results/model.mdex
        [--max-batch 8] [--platforms cuda cpu] [--allow-uninitialized]

The platforms default to ``--device``'s; each is traced on its own device, so
``cuda`` needs a card. float32 with TF32 off, as the live service runs.
"""

from __future__ import annotations

import os

from ..train.checkpoint import checkpoint_path
from ..train.export import PLATFORMS, export_predict, save_exported
from .common import (bootstrap_model, live_missing_keys, parse_config, resolve_paths,
                     set_float32_precision, tool_device)
from .serve import _buckets


def main(argv=None) -> dict:
    """Export and write the archive; returns its meta."""
    def extra(p):
        p.add_argument("--out", required=True, help="output archive path")
        p.add_argument("--max-batch", type=int, default=8)
        p.add_argument("--platforms", nargs="*", default=None, choices=PLATFORMS,
                       help="target platforms (default: --device's); e.g. --platforms cuda "
                            "cpu for an archive of both")
        p.add_argument("--allow-uninitialized", action="store_true",
                       help="export random weights when no checkpoint exists (dev/smoke only)")

    cfg, args = parse_config("Export an ahead-of-time serving artifact", extra=extra, argv=argv)
    set_float32_precision()
    device = tool_device(args.device)
    paths = resolve_paths(cfg)
    ckpt = checkpoint_path(paths["results_dir"], cfg.experiment.model_name)
    if not os.path.exists(ckpt):
        if not args.allow_uninitialized:
            raise FileNotFoundError(
                f"checkpoint {ckpt} not found; refusing to export a randomly initialized "
                "model (--allow-uninitialized to override)")
        ckpt = None
    model, report = bootstrap_model(cfg, device, checkpoint=ckpt)
    if report is not None:
        missing = live_missing_keys(model, report)
        if missing:
            raise ValueError(f"checkpoint {ckpt} leaves {len(missing)} weights of the model "
                             f"unset (e.g. {missing[:3]}); refusing to export it")
    buckets = _buckets(args.max_batch)
    platforms = args.platforms or [device.type]
    print(f"Exporting {cfg.experiment.model_name} buckets {buckets} for {platforms} "
          f"(checkpoint: {ckpt or 'NONE - random weights'})")
    bundle = export_predict(model, cfg, buckets, platforms=platforms)
    save_exported(args.out, bundle)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"Wrote {args.out} ({size_mb:.1f} MB, weights {len(bundle['weights']) / 1e6:.1f} MB, "
          f"seconds to export by platform and bucket {bundle['meta']['export_seconds']})")
    return bundle["meta"]


if __name__ == "__main__":
    main()

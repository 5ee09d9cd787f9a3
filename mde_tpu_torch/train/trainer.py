"""Training, evaluation and prediction steps and the epoch loop (port of
mde_tpu/train/trainer.py).

- ``make_optimizer``: AdamW (lr, betas (0.9, 0.999), eps 1e-8, weight decay)
  over the trainable parameters; the frozen DINOv2 subtree is left out, so
  it gets neither an update nor weight decay.
- ``forward_backward`` and ``make_train_step``: uint8 RGB and raw depth ->
  ``preprocess_train`` -> forward in train mode -> ``combined_loss`` ->
  backward -> one AdamW step, with gradient accumulation over microbatches.
- ``make_eval_step``, ``make_metric_step``, ``make_predict_step``: eval mode
  through ``preprocess_eval`` (the K3 kernel on the card).
- ``fit``, ``evaluate``, ``evaluate_full_suite``, ``generate_test_predictions``.

Mixed precision: ``framework.compute_dtype: bfloat16`` runs the forward under
``torch.autocast`` over float32 master weights; autocast keeps norms in
float32 where the JAX package casts the parameters and runs its norms in
bf16 (trainer.py:195-204). The loss is float32 (``pred.float()``). On the
CPU, bfloat16 becomes float32, as in the JAX package.

BatchNorm keeps torch's semantics: the running variance is updated with the
unbiased batch variance, n/(n-1) times flax's biased one (n = B*H*W at the
layer), as in the reference the checkpoints come from.

Randomness: each train step takes an explicit CPU ``torch.Generator``; ``fit``
derives one per step from (seed, epoch, iteration) with ``step_generator``.

Left out: what the JAX ``fit`` does only for multi-process or mesh runs
(process-sharded batches, replicated remainders, barriers, primary-only
writes); see ROADMAP, Queue 1, "Parallel".
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.transforms import make_train_pipeline, preprocess_eval
from ..losses.losses import combined_loss
from ..metrics.metrics import evaluation_metrics, full_metric_suite
from ..ops.kernels import preprocess_u8_plain, si_loss_sums, si_loss_sums_plain
from ..ops.resize import resize_bilinear
from .checkpoint import (checkpoint_path, load_state_dict, load_training_checkpoint,
                         save_training_checkpoint)
from .logging import ExperimentLogger

FROZEN_SUBTREES = ("dinov2",)
LOSS_KEYS = ("si_loss", "silog_loss", "grad_loss", "edge_loss")


def _device(model) -> torch.device:
    return next(model.parameters()).device


def compute_dtype(cfg, device) -> torch.dtype:
    """``framework.compute_dtype`` on ``device``; float32 on the CPU."""
    dtype = getattr(torch, str(cfg.framework.get("compute_dtype", "bfloat16")))
    return torch.float32 if torch.device(device).type == "cpu" else dtype


def step_generator(seed: int, epoch: int, iteration: int) -> torch.Generator:
    """The CPU generator of one train step, derived from (seed, epoch, iteration)."""
    state = np.random.SeedSequence([int(seed), int(epoch), int(iteration)]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def trainable_parameters(model) -> list:
    """Parameters with ``requires_grad`` outside the frozen subtrees; the
    top-level module name decides (``dinov2_head`` is trainable)."""
    return [p for name, p in model.named_parameters()
            if p.requires_grad and name.split(".", 1)[0] not in FROZEN_SUBTREES]


def make_optimizer(model, cfg) -> torch.optim.AdamW:
    """AdamW with torch defaults (src/main.py:26-28,678) over the trainable
    parameters only, the port of ``make_optimizer``'s frozen partition."""
    return torch.optim.AdamW(trainable_parameters(model), lr=float(cfg.framework.learning_rate),
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=float(cfg.framework.weight_decay))


def forward_backward(model, cfg, rgb, depth, dtype=torch.float32, plain: bool = False,
                     scale: float = 1.0):
    """Forward in train mode, ``combined_loss``, backward into ``.grad``.

    rgb: (B, 3, H, W) normalised float32; depth: (B, H, W). ``dtype`` is the
    autocast compute type (float32: none). ``plain=True`` runs the kernels'
    plain versions on any device. The backward is of ``scale * loss`` (the
    microbatch share under accumulation). Returns the detached (loss, parts).
    """
    model.train()
    with torch.autocast(rgb.device.type, dtype=dtype, enabled=dtype != torch.float32):
        pred = model(rgb, plain=plain)
    total, parts = combined_loss(pred.float(), depth, cfg, rgb=rgb,
                                 sums=si_loss_sums_plain if plain else si_loss_sums)
    (total * scale).backward()
    return total.detach(), {k: v.detach() for k, v in parts.items()}


def make_train_step(model, cfg, optimizer, accum_steps: int = 1) -> Callable:
    """step(rgb_u8 (B, H, W, 3) uint8, depth_raw (B, H, W), generator) -> metrics.

    One optimizer update a call. ``accum_steps > 1`` splits the batch into
    that many microbatches, each through the pipeline, forward and backward
    on its own (so BN sees per-microbatch statistics and its running
    statistics ``accum_steps`` momentum updates), with the gradients
    averaged; as mde_tpu's ``make_train_step`` (trainer.py:221-253). The
    metrics are 0-d device tensors, the microbatch means.
    """
    pipeline = make_train_pipeline(bool(cfg.augmentation), cfg.framework.input_size)

    def step(rgb_u8, depth_raw, generator: torch.Generator) -> dict:
        device = _device(model)
        dtype = compute_dtype(cfg, device)
        rgb_u8 = torch.as_tensor(rgb_u8).to(device)
        depth_raw = torch.as_tensor(depth_raw).to(device)
        b = rgb_u8.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        m = b // accum_steps
        optimizer.zero_grad(set_to_none=True)
        metrics = []
        for i in range(accum_steps):
            rgb, depth = pipeline(rgb_u8[i * m:(i + 1) * m], depth_raw[i * m:(i + 1) * m],
                                  generator=generator)
            loss, parts = forward_backward(model, cfg, rgb, depth, dtype, scale=1.0 / accum_steps)
            metrics.append({"loss": loss, **parts})
        optimizer.step()
        return {k: torch.stack([m_[k] for m_ in metrics]).mean() for k in metrics[0]}

    return step


def _eval_forward(model, cfg, rgb_u8, depth_raw):
    input_size = tuple(int(s) for s in cfg.framework.input_size)
    rgb, depth = preprocess_eval(rgb_u8, depth_raw, input_size=input_size)
    return rgb, depth, model(rgb)


def make_eval_step(model, cfg) -> Callable:
    """step(rgb_u8, depth_raw) -> {"loss", *LOSS_KEYS}: eval mode, float32."""

    def step(rgb_u8, depth_raw) -> dict:
        model.eval()
        with torch.inference_mode():
            rgb, depth, pred = _eval_forward(model, cfg, rgb_u8, depth_raw)
            total, parts = combined_loss(pred, depth, cfg, rgb=rgb)
        return {"loss": total, **parts}

    return step


def make_metric_step(model, cfg) -> Callable:
    """Eval-protocol metrics (src/evaluation.py:143-176) of one batch."""
    base = float(cfg.framework.eval_base_thres)
    n_delta = int(cfg.framework.eval_n_delta)

    def step(rgb_u8, depth_raw) -> dict:
        model.eval()
        with torch.inference_mode():
            _, depth, pred = _eval_forward(model, cfg, rgb_u8, depth_raw)
            return evaluation_metrics(pred, depth, base_thres=base, n_delta=n_delta)

    return step


def make_predict_step(model, cfg, plain: bool = False) -> Callable:
    """step(rgb_u8 (B, H, W, 3) uint8) -> (B, *native_size) float32 depth.

    Preprocess, forward in eval mode under ``torch.inference_mode()``, then an
    align-corners resize back to the native submission size
    (src/util.py:305-313). float32 throughout, like the JAX predict step.
    ``plain=True`` runs the kernels' plain versions on any device, the
    reference a kernel run is held against.
    """
    input_size = tuple(int(s) for s in cfg.framework.input_size)
    native = tuple(int(s) for s in cfg.framework.native_size)

    def step(rgb_u8: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            if plain:
                rgb = preprocess_u8_plain(rgb_u8, input_size)
            else:
                rgb = preprocess_eval(rgb_u8, input_size=input_size)
            pred = model(rgb, plain=plain)
            return resize_bilinear(pred, native, align_corners=True)

    return step


def _on(device, batch: dict, key: str) -> torch.Tensor:
    return torch.as_tensor(batch[key]).to(device)


def fit(model, cfg, optimizer, train_loader, val_loader, results_dir: str,
        logger: Optional[ExperimentLogger] = None, start_epoch: int = 0, seed: int = 0,
        log_every: int = 50, best_val: float = float("inf"), best_epoch: Optional[int] = None,
        es_counter: int = 0) -> dict:
    """Epoch loop with the reference's semantics (src/main.py:91-252), as
    mde_tpu's ``fit`` (trainer.py:322-581): per-epoch train and val loss,
    early stopping on the combined val loss with (patience, min_delta), the
    best checkpoint at ``best_model_{model_name}.pth`` (the training payload,
    optimizer included), wandb-schema logging of every iteration and epoch,
    and the best weights reloaded at the end. ``best_val``/``best_epoch``/
    ``es_counter`` seed the early-stopping state on resume. Returns the
    history (train_loss, val_loss, train_time, n_train per epoch).
    """
    logger = logger or ExperimentLogger(disabled=True)
    device = _device(model)
    accum = int(cfg.framework.get("grad_accum_steps", 1))
    bs = getattr(train_loader, "batch_size", None)
    if accum > 1 and bs is not None and bs % accum:
        raise ValueError(f"training.batch_size {bs} is not divisible by "
                         f"framework.grad_accum_steps {accum}")
    train_step = make_train_step(model, cfg, optimizer, accum_steps=accum)
    eval_step = make_eval_step(model, cfg)
    model_name = cfg.experiment.model_name
    num_epochs = int(cfg.training.n_epoch)
    patience = int(cfg.training.early_stopping.patience)
    min_delta = float(cfg.training.early_stopping.min_delta)
    ckpt_path = checkpoint_path(results_dir, model_name)

    best_val = float(best_val)
    best_epoch = start_epoch if best_epoch is None else int(best_epoch)
    counter = int(es_counter)
    early_stop = counter >= patience
    if early_stop:
        print(f"Early-stopping counter restored at {counter}/{patience}; "
              "training already converged — skipping epochs.")
    history = {"train_loss": [], "val_loss": [], "train_time": [], "n_train": []}

    for epoch in range(start_epoch, num_epochs):
        if early_stop:
            print(f"Early stopping triggered at epoch {epoch + 1}")
            break
        t0 = time.time()
        print(f"Epoch {epoch + 1}/{num_epochs}")

        # ---- train: per-iteration records are flushed every log_every steps,
        # so the host reads the device once per flush, not once per step ----
        n_train = 0
        sums = dict.fromkeys(("loss",) + LOSS_KEYS, 0.0)
        pending: list = []

        def flush():
            if not pending:
                return
            values = torch.stack([torch.stack([m[k] for k in sums]) for _, m in pending]).tolist()
            for (bsz_i, _), row in zip(pending, values):
                for k, v in zip(sums, row):
                    sums[k] += v * bsz_i
                logger.log({"iteration_train_loss": row[0] * bsz_i,
                            **{f"iteration_{k}": v * bsz_i for k, v in zip(LOSS_KEYS, row[1:])}})
            pending.clear()

        for it, batch in enumerate(train_loader):
            bsz = int(batch["rgb"].shape[0])
            metrics = train_step(_on(device, batch, "rgb"), _on(device, batch, "depth"),
                                 step_generator(seed, epoch, it))
            n_train += bsz
            pending.append((bsz, metrics))
            if len(pending) >= log_every:
                flush()
        flush()
        train_loss = sums["loss"] / max(n_train, 1)
        train_parts = {k: sums[k] / max(n_train, 1) for k in LOSS_KEYS}
        history["train_time"].append(time.time() - t0)
        history["n_train"].append(n_train)

        # ---- validate ----
        val_sums = dict.fromkeys(("loss",) + LOSS_KEYS, 0.0)
        n_val = 0
        for batch in val_loader:
            bsz = int(batch["rgb"].shape[0])
            m = eval_step(_on(device, batch, "rgb"), _on(device, batch, "depth"))
            for k, v in zip(val_sums, torch.stack([m[k] for k in val_sums]).tolist()):
                val_sums[k] += v * bsz
            n_val += bsz
        val_loss = val_sums["loss"] / max(n_val, 1)
        val_parts = {k: val_sums[k] / max(n_val, 1) for k in LOSS_KEYS}

        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        print(f"Train Loss: {train_loss:.4f} (SI: {train_parts['si_loss']:.4f}, "
              f"Grad: {train_parts['grad_loss']:.4f}, Edge: {train_parts['edge_loss']:.4f})")
        print(f"Val Loss: {val_loss:.4f} (SI: {val_parts['si_loss']:.4f}, "
              f"Grad: {val_parts['grad_loss']:.4f}, Edge: {val_parts['edge_loss']:.4f})")

        # ---- early stopping + best checkpoint (src/main.py:200-230) ----
        if val_loss < best_val - min_delta:
            best_val, best_epoch, counter = val_loss, epoch, 0
            save_training_checkpoint(
                ckpt_path, model, optimizer, epoch=epoch + 1, best_val_loss=best_val,
                best_epoch=best_epoch, early_stopping_counter=counter, train_loss=train_loss,
                val_loss=val_loss,
                config={"model_name": model_name, "num_epochs": num_epochs,
                        "early_stopping": {"patience": patience, "min_delta": min_delta}})
            print(f"New best model saved at epoch {epoch + 1} with validation loss: {val_loss:.4f}")
        else:
            counter += 1
            print(f"EarlyStopping counter: {counter} out of {patience}")
            early_stop = counter >= patience

        logger.log({
            "epoch": epoch,
            "epoch_train_loss": train_loss,
            "epoch_val_loss": val_parts["si_loss"],
            "epoch_val_loss_combined": val_loss,
            **{f"epoch_train_{k}": v for k, v in train_parts.items()},
            **{f"epoch_val_{k}": v for k, v in val_parts.items()},
            "early_stopping_counter": counter,
            "early_stop_triggered": early_stop,
        })
        print(f"The training time for epoch {epoch} is: {time.time() - t0:.2f}s.\n")

    print(f"\nBest model was from epoch {best_epoch + 1} with validation loss: {best_val:.4f}")
    logger.finish()
    if os.path.exists(ckpt_path):  # reload the best weights (src/main.py:250)
        load_state_dict(model, load_training_checkpoint(ckpt_path)["model_state_dict"])
    return history


def evaluate(model, cfg, loader, n_samples: Optional[int] = None) -> dict:
    """Standalone metric evaluation (src/evaluation.py:136-185): batch-weighted
    SI-RMSE / AbsRel / delta averages over the first ``n_samples``, with the
    reference's excess-sample correction on the final batch."""
    metric_step = make_metric_step(model, cfg)
    device = _device(model)
    totals: dict[str, float] = {}
    processed = 0
    for batch in loader:
        if n_samples is not None and processed >= n_samples:
            break
        bsz = int(batch["rgb"].shape[0])
        m = metric_step(_on(device, batch, "rgb"), _on(device, batch, "depth"))
        m = dict(zip(m, torch.stack(list(m.values())).tolist()))
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + v * bsz
        processed += bsz
        if n_samples is not None and processed > n_samples:
            excess = processed - n_samples
            for k, v in m.items():
                totals[k] -= v * excess
            processed = n_samples
    return {k: v / max(processed, 1) for k, v in totals.items()}


def evaluate_full_suite(model, cfg, loader) -> dict:
    """The in-train 7-metric suite with the reference's final normalisation
    (src/main.py:372-392)."""
    device = _device(model)
    sums: dict[str, float] = {}
    n = 0
    for batch in loader:
        model.eval()
        with torch.inference_mode():
            _, depth, pred = _eval_forward(model, cfg, _on(device, batch, "rgb"),
                                           _on(device, batch, "depth"))
            pred = resize_bilinear(pred, depth.shape[-2:], align_corners=True)
            out = full_metric_suite(pred, depth)
        for k, v in zip(out, torch.stack([v.double() for v in out.values()]).tolist()):
            sums[k] = sums.get(k, 0.0) + v
        n += int(batch["rgb"].shape[0])
    denom = max(n * int(np.prod([int(s) for s in cfg.framework.input_size])), 1)
    return {
        "MAE": sums["mae_sum"] / denom,
        "RMSE": float(np.sqrt(sums["sq_sum"] / denom)),
        "siRMSE": sums["sirmse_sum"] / max(n, 1),
        "REL": sums["rel_sum"] / denom,
        "Delta1": sums["delta1_count"] / denom,
        "Delta2": sums["delta2_count"] / denom,
        "Delta3": sums["delta3_count"] / denom,
    }


def generate_test_predictions(model, cfg, loader, predictions_dir: str) -> int:
    """Save one native-size .npy prediction an image, named by the second
    list-file token (src/util.py:292-328). Returns the number written."""
    os.makedirs(predictions_dir, exist_ok=True)
    predict_step = make_predict_step(model, cfg)
    device = _device(model)
    written = 0
    for batch in loader:
        preds = predict_step(_on(device, batch, "rgb")).cpu().numpy()
        for i, name in enumerate(batch["names"]):
            np.save(os.path.join(predictions_dir, name.split(" ")[1]), preds[i])
            written += 1
    return written

"""Training traffic: the program's train step fed by its host loader, epoch
after epoch, as its ``fit`` feeds it, without validation or checkpoints.

Set-up reads the configuration's ``dataset_pairs`` pairs at the native size
from a pool inside the checkout (``harness/synthetic.py``), which the first
run there writes and every later run reads as it is, as a training job reads
its dataset; the run's seed draws the weights, the order of the pairs and
each step's draws. It builds one train step over one model and its optimizer
(``make_optimizer``, ``make_train_step``) and one ``HostLoader`` over the
pairs. Every step takes a CPU generator made from (the run's step seed,
epoch, iteration) as the program's ``step_generator`` makes it. The first
``checked_steps`` steps go through the window's own loop on distinct rows
(the first epoch's first batches), and the output check follows them; then
the rest of ``warmup_steps``; then the window, on the same objects.

Parameters (the cell's ``params``):
- ``num_workers``: the loader's decode threads;
- ``checked_steps``, ``warmup_steps``: as above;
- ``data_processes``: processes that write the pool, where it is not there yet;
- ``trace_s``: the profiled sub-window of a traced run, in the window's middle.

The rate counts every optimizer step the window completes, over the
window's seconds, which end after a synchronise. The output check compares
each checked step's loss, the first step's prediction, the first gradient
as the optimizer got it (its first moment after one step, over 1 - beta1)
and the parameters' change after the checked steps with the reference's:
per leaf, the gap of their norms and the distance of the tensors, and per
top-level part of the model, the distance (``harness/compare.py``).
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from ..harness import compare, spec, synthetic
from ..harness.trace import DeviceTrace, per_interval, profiled
from ..harness.weights import subseed
from ..reference import pipeline

BETA1 = 0.9  # the optimizer's first-moment decay, torch's AdamW default


def step_generator(seed: int, epoch: int, iteration: int) -> torch.Generator:
    """The CPU generator of one train step, from (seed, epoch, iteration)."""
    state = np.random.SeedSequence([int(seed), int(epoch), int(iteration)]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    if not names:
        return {}
    values = torch.stack([tensors[k].detach().double().norm() for k in names]).tolist()
    return dict(zip(names, values))


class Driver:
    mode = "train"

    def __init__(self, run, model):
        self.run, self.model = run, model
        self.p = run.params
        self.step_seed = subseed(run.seed, "steps")

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from mde_tpu_torch.data.dataset import DepthDataset
        from mde_tpu_torch.data.loader import HostLoader
        from mde_tpu_torch.tools.common import set_float32_precision
        from mde_tpu_torch.train.trainer import make_optimizer, make_train_step

        run, p, cfg = self.run, self.p, self.run.cfg
        set_float32_precision()  # as the training command line does: TF32 off
        root = synthetic.pool(spec.ROOT / "_bench_cache" / "pairs",
                              int(run.config_file["dataset_pairs"]), cfg.framework.native_size,
                              int(p["data_processes"]))
        run.mark("pairs")
        self.train_dir = str(root / "train")
        dataset = DepthDataset(self.train_dir, str(root / "train_list.txt"), has_gt=True)
        self.batch = int(cfg.training.batch_size)
        self.loader = HostLoader(dataset, batch_size=self.batch, shuffle=True, drop_last=True,
                                 num_workers=int(p["num_workers"]),
                                 seed=subseed(run.seed, "loader"),
                                 prefetch_depth=int(cfg.framework.prefetch_depth), cache=False,
                                 device=run.device)
        self.optimizer = make_optimizer(self.model, cfg)
        self.step = make_train_step(self.model, cfg, self.optimizer,
                                    accum_steps=int(cfg.framework.grad_accum_steps))
        self.batches = self._epochs()
        names = dict((id(q), k) for k, q in self.model.named_parameters())
        self.trainable = {names[id(q)]: q for g in self.optimizer.param_groups for q in g["params"]}
        self.checked, losses, preds = [], [], []
        # the first step's prediction, as the forward inside it gives it
        hook = self.model.register_forward_hook(
            lambda module, args, out: preds.append(out.detach().float().cpu()) if not preds else None)
        for i in range(int(p["checked_steps"])):
            epoch, it, batch = next(self.batches)
            metrics = self.step(batch["rgb"], batch["depth"],
                                step_generator(self.step_seed, epoch, it))
            self.checked.append((epoch, it, list(batch["names"])))
            losses.append(metrics["loss"])
            if i == 0:  # the gradient as the optimizer got it, on the host
                hook.remove()
                self.first_pred = preds[0]
                state = self.optimizer.state
                self.first_grad = {k: (state[q]["exp_avg"] / (1 - BETA1)).cpu()
                                   for k, q in self.trainable.items() if q in state}
        self.losses = torch.stack(losses).tolist()
        run.mark("checked steps")
        start = run.state
        self.change = {k: q.detach().cpu() - start[k] for k, q in self.trainable.items()}
        for _ in range(int(p["warmup_steps"]) - int(p["checked_steps"])):
            self._one()
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _epochs(self):
        for epoch in itertools.count():
            for it, batch in enumerate(self.loader):
                yield epoch, it, batch

    def _one(self) -> None:
        spans = self.run.spans
        with spans.span("loader.next"):
            epoch, it, batch = next(self.batches)
        with spans.span("train_step"):
            self.step(batch["rgb"], batch["depth"], step_generator(self.step_seed, epoch, it))

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        run = self.run
        cuda = torch.cuda.is_available()
        t0 = time.time_ns()
        run.window_started(t0)
        end = t0 + int(seconds * 1e9)
        steps = 0
        if run.trace:
            trace_s = min(float(self.p["trace_s"]), seconds / 2)
            start_trace = t0 + int((seconds - trace_s) / 2 * 1e9)
            while time.time_ns() < start_trace:
                self._one()
                steps += 1
            with profiled() as (prof, mark):
                while time.time_ns() < mark.mark_ns + trace_s * 1e9:
                    self._one()
                    steps += 1
                t_end = time.time_ns()
            run.record["trace"] = DeviceTrace(prof, mark.mark_ns, mark.mark_ns, t_end)
        while time.time_ns() < end:
            self._one()
            steps += 1
        if cuda:
            torch.cuda.synchronize()
        t1 = time.time_ns()
        window_s = (t1 - t0) / 1e9
        self.attempted, self.failed = steps, 0
        run.record.update(window_s=window_s, steps=steps, batch=self.batch, t0=t0, t1=t1)
        starts = [a for name, a, _ in run.spans.items if name == "train_step"]
        waits = run.spans.between("loader.next", t0, t1)
        self.window_detail = {"steps_by_5s": per_interval(starts, t0, t1, 5e9),
                              "loader_waits_over_50ms": sum(1 for w in waits if w > 0.05)}
        return {"train_samples_per_s": steps * self.batch / window_s}

    def release(self) -> None:
        self.batches.close()  # ends the loader's epoch: its threads stop
        del self.step, self.optimizer, self.model, self.trainable, self.loader

    # -- the output check ----------------------------------------------------
    def candidate(self) -> dict:
        return {"losses": self.losses, "pred": self.first_pred, "grad": self.first_grad,
                "change": self.change}

    def _rows(self, names: list):
        rgb, depth = [], []
        for entry in names:
            rgb_name, depth_name = entry.split()[:2]
            rgb.append(synthetic.read_png(os.path.join(self.train_dir, rgb_name)))
            depth.append(np.load(os.path.join(self.train_dir, depth_name)))
        device = self.run.device
        return torch.from_numpy(np.stack(rgb)).to(device), torch.from_numpy(np.stack(depth)).to(device)

    def reference(self, state: dict, precision) -> dict:
        """The reference's checked steps from the same weights, rows and draws,
        computed under ``precision``."""
        run, cfg = self.run, self.run.cfg
        ref = run.reference_model(state)
        ref.train()
        params = {k: q for k, q in ref.named_parameters() if q.requires_grad}
        opt = pipeline.AdamW(params, float(cfg.framework.learning_rate),
                             float(cfg.framework.weight_decay))
        alpha = float(cfg.model.loss_function.si_loss_alpha)
        losses, first_grad, first_pred = [], None, None
        for epoch, it, names in self.checked:
            rgb_u8, depth = self._rows(names)
            rgb, target = pipeline.preprocess_train(rgb_u8, depth, cfg.framework.input_size,
                                                    step_generator(self.step_seed, epoch, it))
            with precision():
                pred = ref(rgb)
                loss = pipeline.si_loss(pred, target) * alpha
                loss.backward()
            if first_pred is None:
                first_pred = pred.detach().float().cpu()
            losses.append(float(loss.detach()))
            if first_grad is None:  # leaves that no forward reads get none
                first_grad = {k: q.grad.detach().cpu() for k, q in params.items()
                              if q.grad is not None}
            opt.step()
            for q in params.values():
                q.grad = None
        change = {k: q.detach().cpu() - state[k] for k, q in params.items()}
        return {"losses": losses, "pred": first_pred, "grad": first_grad, "change": change}

    def numbers(self, candidate: dict, reference: dict) -> dict:
        norms = {key: {"cand": _norms(candidate[key]), "ref": _norms(reference[key])}
                 for key in ("grad", "change")}
        leaves = compare.moving_leaves(norms["grad"]["ref"])
        out = {f"loss_gap.step{i + 1}": compare.loss_gap(a, b)
               for i, (a, b) in enumerate(zip(candidate["losses"], reference["losses"]))}
        self.detail = {**getattr(self, "window_detail", {}),
                       "losses": [candidate["losses"], reference["losses"]],
                       "leaves": [len(leaves), len(reference["grad"])]}
        out["pred_gap.step1"] = compare.map_gap(candidate["pred"], reference["pred"])
        out["pred_rel.step1"] = compare.median_gap(candidate["pred"], reference["pred"])
        self.per_leaf = {}
        for key in ("grad", "change"):
            cand, ref = norms[key]["cand"], norms[key]["ref"]
            gaps = compare.leaf_gaps(cand, ref, leaves)
            out[f"{key}_gap"], leaf = compare.worst(gaps)
            out[f"{key}_gap.median"] = compare.median(gaps)
            self.detail[f"{key}_gap_worst"] = [leaf, cand.get(leaf), ref[leaf]]
            dist = compare.leaf_distances(candidate[key], reference[key], leaves)
            out[f"{key}_rel"], leaf = compare.worst(dist)
            out[f"{key}_rel.median"] = compare.median(dist)
            self.detail[f"{key}_rel_worst"] = leaf
            parts = compare.part_distances(candidate[key], reference[key], leaves)
            out[f"{key}_rel.part"], part = compare.worst(parts)
            self.detail[f"{key}_rel_part"] = part
            self.per_leaf[key] = {"rel": dist, "part": parts}
        return out

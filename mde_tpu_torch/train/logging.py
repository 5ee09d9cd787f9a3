"""Experiment logging with the reference's wandb schema (a copy of
mde_tpu/train/logging.py that imports wandb only when a logger is enabled).

The reference logs to wandb project "MonocularDepthEstimation" with per-iteration
loss components and per-epoch aggregates under fixed key names
(src/main.py:153-156, 232-241, 552-568). This logger keeps those key names so
dashboards stay comparable; when wandb is unavailable (as in this environment) it
falls back to a JSONL file + stdout, with the same init/log/finish surface.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping, Optional


def _import_wandb():
    try:  # pragma: no cover - exercised only where wandb is installed
        import wandb
    except ImportError:
        return None
    return wandb


class ExperimentLogger:
    def __init__(
        self,
        project: str = "MonocularDepthEstimation",
        name: Optional[str] = None,
        run_id: Optional[str] = None,
        resume: bool = False,
        config: Optional[Mapping[str, Any]] = None,
        disabled: bool = False,
        log_dir: str = "results",
    ):
        self.disabled = disabled
        self._wandb_run = None
        self._jsonl = None
        if disabled:
            return
        wandb = _import_wandb()
        if wandb is not None:
            self._wandb_run = wandb.init(
                project=project,
                name=None if resume else name,
                id=run_id if resume else None,
                resume="allow" if resume else None,
                config=dict(config) if config else None,
            )
        else:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"{name or 'run'}.log.jsonl")
            self._jsonl = open(path, "a")
            if config:
                self._write({"_event": "init", "project": project, "name": name, "config": dict(config)})

    def _write(self, record: Mapping[str, Any]) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"_ts": time.time(), **record}) + "\n")
            self._jsonl.flush()

    def log(self, metrics: Mapping[str, Any]) -> None:
        if self.disabled:
            return
        metrics = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        if self._wandb_run is not None:
            self._wandb_run.log(metrics)
        else:
            self._write(metrics)

    def finish(self) -> None:
        if self._wandb_run is not None:
            self._wandb_run.finish()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

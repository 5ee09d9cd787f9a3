"""Finds every part of a cell by its name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configurations and their metrics. Each part lives in a file of its own under
``gpubench/``, found by that name, so that a later change adds a
configuration, a cell or a metric by adding files and entries alone:

- ``configs/<config>.json``: a configuration (the program's ``--set``s, its
  source, widths, cuts, precisions, its reference module);
- ``workloads/<cell>.json``: a cell (its configuration, the program's
  ``--set``s of its traffic, such as the train batch, its traffic driver and
  the driver's parameters, the limits of its output check);
- ``traffic/<driver>.py``: a traffic driver;
- ``metrics/<metric>.py``: a per-layer metric's reader;
- ``reference/<module>.py``: a plain PyTorch reference model.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def entry(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"{what} {name!r} is not in BENCHMARK.json")


def workload(name: str) -> dict:
    """The cell's file, with its configuration's file under ``"config_file"``."""
    cell = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    cell["config_file"] = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    return cell


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind] if applies(m, cell)]


def metric_reader(name: str):
    """``metrics/<name>.py`` as a module (its name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return importlib.import_module(f"gpubench.traffic.{name}")


def reference(name: str):
    return importlib.import_module(f"gpubench.reference.{name}")

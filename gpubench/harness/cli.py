"""``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Runs one cell once on the card this process is started on and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced, the
``breakdown``, then last ``check``: each number compared with its limit.
The same numbers close standard error. It prints no result, and exits
non-zero, where no card (or too few) is visible, where the program is not
in the checkout, and where ``jax``, ``jaxlib``, ``flax`` or the JAX package
was loaded by the time the window closed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys

FORBIDDEN = {"jax", "jaxlib", "flax", "mde_tpu"}


def loaded_forbidden(modules=None) -> set:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    compared whole: ``mde_tpu_torch`` is not ``mde_tpu``."""
    names = list(sys.modules) if modules is None else modules
    return {name.split(".", 1)[0] for name in names} & FORBIDDEN


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(outcome, bench: dict, chips: int) -> dict:
    """The result's JSON object for a finished run (``cell.Outcome``)."""
    import torch

    from . import spec

    run, driver = outcome.run, outcome.driver
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, run.name, kind):
        if kind == "end_to_end":
            value = {"setup_s": outcome.setup_s, "peak_mib": outcome.peak / 2**20,
                     **outcome.e2e}[m["name"]]
        else:
            value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": outcome.peak}
    out = {"correct": outcome.correct, "attempted": driver.attempted, "failed": driver.failed,
           "metrics": metrics, "device": device}
    trace = run.record.get("trace")
    if run.trace and trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        out["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.gaps(run.spans)}
    out["check"] = outcome.checks()
    return out


def main(t_start_ns: int, argv=None) -> int:
    args = parse(argv)
    from . import spec

    bench = spec.benchmark()
    cell = spec.entry(bench["workloads"], args.workload, "workload")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("mde_tpu_torch") is None:
        print("the program (mde_tpu_torch) is not in this checkout", file=sys.stderr)
        return 3
    from .cell import run_cell

    outcome = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                       t_start_ns)
    try:
        found = loaded_forbidden()
        if found:
            print(f"loaded in this process: {sorted(found)}", file=sys.stderr)
            return 4
        line = result_line(outcome, bench, cell["chips"])
    finally:
        outcome.close()
    detail = {**(getattr(outcome.driver, "detail", None) or {}),
              "setup_timeline": outcome.run.timeline, "numbers": outcome.numbers}
    print(f"detail: {json.dumps(detail)}", file=sys.stderr)
    for name, c in line["check"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})", file=sys.stderr)
    print(json.dumps(line))
    return 0

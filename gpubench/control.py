"""The output check's readings, for setting its limits: the program's numbers
over many seeds and the control's, in one process.

``python3 gpubench/control.py --workload <cell> --seeds 1,2,3 --seconds 2
[--control]`` runs the cell once a seed (set-up, a short window at the
cell's own load, the output check) and prints one JSON line a seed: the
numbers compared, the run's end-to-end values and, with ``--control``, the
control's numbers: the reference computed in the precision below the one
the configuration states (TF32 for float32, float8 e4m3 for bfloat16),
put in the program's place (``harness/precision.py``); ``--precision
NAME`` puts it there in another precision of that module instead (a
witness). ``--set KEY=VALUE``
adds a program ``--set`` (a witness run, such as the program in float32);
``--fault NAME`` plants a fault of ``harness/faults.py`` in the program
for every run; ``--leaves`` adds a train cell's readings leaf by leaf and
part by part. The benchmark's own runs do not run it.
"""

import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpubench.harness import faults, spec  # noqa: E402
from gpubench.harness.cell import control_numbers, run_cell  # noqa: E402


def _rounded(tree):
    if isinstance(tree, dict):
        return {k: _rounded(v) for k, v in tree.items()}
    return float(f"{tree:.4g}") if isinstance(tree, float) else tree


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--precision", default=None)
    p.add_argument("--set", action="append", default=[], dest="sets")
    p.add_argument("--fault", default=None)
    p.add_argument("--leaves", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        mode = spec.driver(spec.workload(args.workload)["driver"]).Driver.mode
        with faults.planted(mode, args.fault) if args.fault else contextlib.nullcontext():
            outcome = run_cell(args.workload, seed, args.seconds, False, "cuda", time.time_ns(),
                               {"sets": args.sets} if args.sets else None)
        try:
            line = {"workload": args.workload, "seed": seed, "sets": args.sets, "fault": args.fault,
                    "numbers": outcome.numbers, "correct": outcome.correct,
                    "detail": getattr(outcome.driver, "detail", None), "e2e": outcome.e2e,
                    "setup_s": outcome.setup_s}
            if args.leaves:
                line["per_leaf"] = _rounded(getattr(outcome.driver, "per_leaf", None))
            if args.control:
                line["control"] = control_numbers(outcome, args.precision)
                line["control_detail"] = getattr(outcome.driver, "detail", None)
                if args.leaves:
                    line["control_per_leaf"] = _rounded(getattr(outcome.driver, "per_leaf", None))
        finally:
            outcome.close()
        print(json.dumps(line), flush=True)
        del outcome
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

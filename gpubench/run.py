"""Run one benchmark cell once: ``python3 gpubench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout
(``harness/cli.py``). Set-up is timed from the first line here."""

import time

T_START_NS = time.time_ns()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Triton's kernel cache at a fixed path inside the checkout, so that only a
# cell's first run there compiles (the program builds its own kernels into
# mde_tpu_torch/_build, also inside the checkout).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "_bench_cache" / "triton")
sys.path.insert(0, str(ROOT))

from gpubench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T_START_NS))

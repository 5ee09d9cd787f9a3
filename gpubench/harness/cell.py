"""One run of one cell: set-up, the measured window, the output check.

``run_cell`` is the whole run but the look for a card and the printing
(``cli.py``), so that the CPU tests and the control (``control.py``) drive
the same path. A traffic driver (``traffic/<driver>.py``) gives ``Driver``
with ``setup()``, ``window(seconds) -> end-to-end values``, ``release()``
(frees the program's state), ``candidate()``, ``reference(state,
precision)`` and ``numbers(candidate, reference) -> {name: gap}``, and may
give ``close()`` (``Outcome.close``, once the caller is done).
"""

from __future__ import annotations

import gc
import math
import time

import torch

from . import precision, program, spec
from .trace import Spans


class Run:
    """What a driver and the metric readers see of a run. The program's
    config is the configuration's ``--set``s, then the cell's (``"sets"``).
    ``overrides`` (the CPU tests') may replace ``params`` entries
    (``"params"``), configuration entries (``"config"``), add ``--set``s
    after those (``"sets"``) and keyword arguments
    of the program's and the reference's model classes (``"model_kwargs"``,
    ``"reference_kwargs"``)."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device: str,
                 overrides=None):
        ov = overrides or {}
        cell = spec.workload(name)
        self.name, self.seed, self.seconds, self.trace = name, int(seed), seconds, trace
        self.device = torch.device(device)
        self.cell = cell
        self.config_file = {**cell["config_file"], **ov.get("config", {})}
        self.params = {**cell["params"], **ov.get("params", {})}
        self.model_kwargs = ov.get("model_kwargs")
        self.reference_kwargs = ov.get("reference_kwargs")
        self.cfg = program.config(self.config_file, [*cell.get("sets", ()), *ov.get("sets", ())])
        self.spans = Spans()
        self.record: dict = {}
        self.state = None  # the seeded weights, on the CPU
        self.t_window = None
        self.t_start = None
        self.timeline = []  # (step of set-up, seconds since the process started)

    def mark(self, step: str) -> None:
        self.timeline.append((step, round((time.time_ns() - self.t_start) / 1e9, 3)))

    def window_started(self, t_ns: int) -> None:
        self.t_window = t_ns

    def reference_model(self, state: dict):
        ref = program.reference_model(self.config_file, "meta", self.reference_kwargs)
        ref = ref.to_empty(device=self.device)
        ref.load_state_dict(state, strict=True)
        return ref


class Outcome:
    """A finished run: its driver, its end-to-end values, the numbers
    compared and the reference's outputs they were compared with."""

    def __init__(self, run, driver, e2e, setup_s, peak, numbers, reference):
        self.run, self.driver, self.e2e, self.setup_s = run, driver, e2e, setup_s
        self.peak, self.numbers, self.reference = peak, numbers, reference

    def checks(self) -> dict:
        limits = self.run.cell["limits"]
        return {k: {"value": v, "limit": limits[k]} for k, v in self.numbers.items()
                if k in limits}

    @staticmethod
    def close_driver(driver) -> None:
        if hasattr(driver, "close"):
            driver.close()

    def close(self) -> None:
        """Stop what the driver started (the serving clients and service)."""
        self.close_driver(self.driver)

    @property
    def correct(self) -> bool:
        d = self.driver
        passed = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                     for c in self.checks().values())
        return passed and set(self.checks()) == set(self.run.cell["limits"]) \
            and d.failed == 0 and d.attempted > 0


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             t_start_ns: int, overrides=None) -> Outcome:
    run = Run(name, seed, seconds, trace, device, overrides)
    run.t_start = t_start_ns
    run.mark("config")
    cuda = run.device.type == "cuda"
    driver_cls = spec.driver(run.cell["driver"]).Driver
    state = program.weights(run.config_file, driver_cls.mode, run.seed, run.device,
                            run.reference_kwargs)
    model = program.model(run.cfg, state, run.device, run.model_kwargs)
    run.state = {k: v.cpu() for k, v in state.items()}
    del state
    run.mark("model")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    driver = driver_cls(run, model)
    del model
    try:
        driver.setup()
        run.mark("setup")
        e2e = driver.window(seconds)
        setup_s = (run.t_window - t_start_ns) / 1e9
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        driver.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        reference = driver.reference(run.state, precision.float32)
        numbers = driver.numbers(driver.candidate(), reference)
    except BaseException:
        Outcome.close_driver(driver)
        raise
    return Outcome(run, driver, e2e, setup_s, peak, numbers, reference)


def control_numbers(outcome: Outcome, name=None) -> dict:
    """The control's numbers: the reference in the precision below the
    configuration's (or in the precision ``name``), put in the program's
    place, against the reference."""
    run = outcome.run
    stated = run.config_file["precision"][outcome.driver.mode]
    lower = precision.PRECISIONS[name or precision.CONTROL_OF[stated]]
    return outcome.driver.numbers(outcome.driver.reference(run.state, lower), outcome.reference)

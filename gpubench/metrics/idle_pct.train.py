"""The share (%) of the traced sub-window in which no operation ran on the
card, in a train cell (``harness/trace.py::idle_pct``)."""

from gpubench.harness.trace import idle_pct as read  # noqa: F401

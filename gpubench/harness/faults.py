"""Faults planted in the program's timed path, underneath the harness: the
output check has to come out false with each (``tests/test_gpubench_faults.py``),
and a training cell's limits are read against them (``control.py --fault``).

- ``state_unchanged``: the train step's optimizer update does nothing.
- ``half_batch``: the train step's forward and loss see the first half of
  each batch's rows, the mean taken over those; the predict step computes
  the first half of a bucket's rows and hands them out for the second half
  too.
- ``grad_negated``: the train step's backward hands the optimizer every
  gradient negated (an ascent): the change's norms stay as they were.
- ``answer_altered``: the predict step's first map has one value raised by
  one unit where it is produced.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

FAULTS = {"train": ("state_unchanged", "half_batch", "grad_negated"),
          "serve": ("half_batch", "answer_altered")}


@contextlib.contextmanager
def _patched(owner, name: str, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _half_predict(make):
    def make_step(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(rgb_u8):
            n = rgb_u8.shape[0]
            half = max(1, n // 2)
            out = step(rgb_u8[:half])
            return out.repeat((n + half - 1) // half, 1, 1)[:n]

        return broken

    return make_step


def _altered_predict(make):
    def make_step(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(rgb_u8):
            out = step(rgb_u8).clone()
            out[0, 0, 0] += 1.0
            return out

        return broken

    return make_step


def _half_forward(forward_backward):
    def broken(model, cfg, rgb, depth, *args, **kwargs):
        half = max(1, rgb.shape[0] // 2)
        return forward_backward(model, cfg, rgb[:half], depth[:half], *args, **kwargs)

    return broken


def _negated_backward(forward_backward):
    def broken(model, *args, **kwargs):
        out = forward_backward(model, *args, **kwargs)
        for q in model.parameters():
            if q.grad is not None:
                q.grad.neg_()
        return out

    return broken


@contextlib.contextmanager
def planted(mode: str, name: str):
    """The fault ``name`` of a ``mode`` ("train" or "serve") cell, in place
    for the block."""
    import torch

    from mde_tpu_torch.tools import serve
    from mde_tpu_torch.train import trainer

    if name not in FAULTS[mode]:
        raise ValueError(f"no fault {name!r} for a {mode} cell; faults: {FAULTS[mode]}")
    if mode == "train" and name == "state_unchanged":
        patch = _patched(torch.optim.AdamW, "step", lambda self, closure=None: None)
    elif mode == "train" and name == "half_batch":
        patch = _patched(trainer, "forward_backward", _half_forward(trainer.forward_backward))
    elif mode == "train":
        patch = _patched(trainer, "forward_backward", _negated_backward(trainer.forward_backward))
    elif name == "half_batch":
        patch = _patched(serve, "make_predict_step", _half_predict(serve.make_predict_step))
    else:
        patch = _patched(serve, "make_predict_step", _altered_predict(serve.make_predict_step))
    with patch:
        yield

"""The train steps' share (%) of the card's bfloat16 peak: the forward,
loss and backward FLOP of a batch (counted over the reference,
``roofline/model.py``) times the window's steps, over its seconds."""

from gpubench.roofline.model import mfu_pct


def read(run):
    steps = run.record.get("steps")
    return mfu_pct(run, steps, run.record["batch"], train=True) if steps else None

"""The served frames' share (%) of the card's float32 peak: the model's FLOP
a frame (counted over the reference, ``roofline/model.py``) times the
replies of the window, over its seconds."""

from gpubench.roofline.model import mfu_pct


def read(run):
    frames = run.record.get("frames")
    return mfu_pct(run, frames, 1, train=False) if frames else None

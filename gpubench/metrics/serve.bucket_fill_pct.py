"""The share (%) of the rows that the window's device steps ran which carry a
frame: each step runs its bucket whole (1, 2, 4, ... ``max_batch``), and the
batcher pads the rows that no request fills. From each reply's rows of its
step (``DepthService.predict_bytes``) and the batcher's buckets."""


def read(run):
    rows = run.record.get("rows_run")
    return 100.0 * run.record["replies"] / rows if rows else None

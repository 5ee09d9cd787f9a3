"""Rows a device step of the dynamic batcher carries, over the window: the
batcher's own counters (``DynamicBatcher.stats``), requests over device
steps."""


def read(run):
    counts = run.record.get("batcher")
    if not counts or counts["device_steps"] == 0:
        return None
    return counts["requests"] / counts["device_steps"]

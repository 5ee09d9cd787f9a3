"""Host milliseconds a train step waits on the loader: the benchmark's span
around ``next()`` on the ``HostLoader``'s iterator, the mean over the
window's steps."""


def read(run):
    rec = run.record
    waits = run.spans.between("loader.next", rec.get("t0", 0), rec.get("t1", 0))
    return 1e3 * sum(waits) / len(waits) if waits else None

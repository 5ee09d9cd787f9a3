"""Host milliseconds of the train step's call, the mean over the window's
steps: the benchmark's span around it. The step does not synchronise, so
this is the time to enqueue its work (and to wait where the launch queue or
the host's reads hold it)."""


def read(run):
    rec = run.record
    calls = run.spans.between("train_step", rec.get("t0", 0), rec.get("t1", 0))
    return 1e3 * sum(calls) / len(calls) if calls else None

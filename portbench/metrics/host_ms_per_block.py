"""Mean host time of a ``Chain.step`` call, in ms: the benchmark's span
around each call of the traced run's window, the profiled sub-window left
out (the profiler slows the host)."""


def read(run):
    return 1e3 * sum(run.spans) / len(run.spans) if run.spans else None

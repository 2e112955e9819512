"""The share of the traced sub-window in which the device ran no
kernel, copy or fill (rank 0's device in a sharded run)."""


def read(run):
    t = run.trace
    return 1.0 - t.busy_s / t.window_s if t is not None and t.window_s > 0 and t.device else None

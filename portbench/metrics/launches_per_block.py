"""Kernels, copies and fills the device ran a block in the traced
sub-window (the profiler's device events over its blocks)."""


def read(run):
    t = run.trace
    return t.launches() / t.units if t is not None and t.units and t.device else None

"""Device time of NCCL's kernels a sharded call on rank 0, in ms (the
halo exchanges, the floor's broadcast and the spill, waiting on peers
included), from the traced sub-window."""


def read(run):
    t = run.trace
    if t is None or not t.units or not t.device:
        return None
    return 1e3 * t.kernel_s(nccl=True) / t.units

"""The whole chain's roofline share of a streamed block, in %: the
least time of a block (``work/<config>``: its bytes over 3.35 TB/s or its
float32 operations over 67 TFLOP/s, the larger) over the summed device
time of its kernels in the traced sub-window, NCCL's left out."""

from portbench.roofline import bound_s


def read(run):
    t = run.trace
    if t is None or not t.units or t.kernel_s(nccl=False) <= 0.0:
        return None
    return 100.0 * bound_s(*run.unit_work)[0] / (t.kernel_s(nccl=False) / t.units)

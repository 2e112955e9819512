"""Shared fixtures of the benchmark's tests: tiny versions of each cell
for the CPU, and the card's fixture (decided inside it, never while a
module is imported)."""

import pytest
import torch

from portbench import harness

TINY = {
    "fir_gate_48k.file": dict(stack=1, seconds=0.25, pool=2, sample=3, trace_from=1,
                              trace_units=2, ref_rows=4),
    "config5_128ch.stream": dict(pool_seconds=0.6, sample=4, trace_from=2, trace_units=3),
    "fir_gate_48k.stream512": dict(stack=1, pool_seconds=0.4, sample=4, trace_from=2,
                                   trace_units=3),
    "config5_128ch.sharded4": dict(stack=1, frames=4 * 4704 * 2, sample=1, trace_from=1,
                                   trace_units=2, ref_rows=2),
}
"""Each cell's traffic cut to a CPU test's size (config 5 to 2 channels)."""


def tiny_spec(cell: str, patch: str | None = None) -> dict:
    spec = harness.cell_spec(cell)
    spec["traffic"].update(TINY[cell])
    if spec["config_name"] == "config5_128ch":
        spec["config"]["channels"] = 2
    if patch:
        spec["patch"] = f"portbench.tests.faults:{patch}"
    return spec


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a process: several test workers, each with its
    ranks, share the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: no CUDA device here")
    return torch.device("cuda", 0)

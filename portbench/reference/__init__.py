"""The plain float64 reference: PyTorch and NumPy only, nothing of the
program under test and nothing of the JAX package."""

from portbench.reference.chain import (  # noqa: F401
    chain_floors, design_taps, out_len, run_chain, stream_latency,
)

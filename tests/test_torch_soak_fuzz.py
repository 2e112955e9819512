"""Twins of tests/integration/test_soak_short.py (both soaks) and of
tests/kernels/test_fuzz_params.py::test_gate_fuzz on the CPU.

The soaks run the port's float32 plain path (the stream kernels' plain
versions) to the reference's bars: the vocoder stream >= 95 dB against
``oracle.time_stretch``; the composite stream >= 60 dB overall with its
last quarter within 15 dB of its second.  Their float64 references in
``torch_soak_fuzz`` (which the card twins use) equal the oracle's.  The
gate fuzz runs ``noise_gate_fused`` on float64 CPU tensors (its plain
version) over the reference's six cases against ``oracle.noise_gate``.
The bf16x3 fixture of the reference soaks is TPU-only and has no twin.
"""

import numpy as np
import pytest
import torch

import torch_soak_fuzz as soak
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu_torch.kernels.gate_kernel import noise_gate_fused

F64 = dict(rtol=1e-8, atol=1e-10)  # float64 port vs the oracle, tests/test_torch_gate.py's


def test_stretch_soak_short():
    """32 drained vocoder blocks (4/3) in float32 >= 95 dB against the
    oracle; the port's float64 whole-file vocoder equals the oracle."""
    x = soak.stretch_input()
    y = soak.stretch_chain().stream(torch.as_tensor(x), soak.STRETCH_BLOCK, drain=True)
    ref = np.stack([oracle.time_stretch(c.astype(np.float64), 4 / 3, 1024, 256) for c in x])
    ref64 = soak.stretch_ref64(x).numpy()
    np.testing.assert_allclose(ref64, ref, **F64)
    assert soak.stretch_snr(ref, y) >= soak.STRETCH_MIN_DB


def test_composite_soak_short_flat():
    """24 drained composite blocks in float32: >= 60 dB overall and a flat
    profile (last quarter within 15 dB of the second) against the oracle
    chain; the port's float64 chain equals the oracle's."""
    x = soak.composite_input()
    y = soak.composite_chain().stream(torch.as_tensor(x), soak.COMPOSITE_BLOCK, drain=True)
    h, he = soak.composite_taps()
    base = [oracle.noise_gate(oracle.fir_direct(
        oracle.resample_poly(c.astype(np.float64), 160, 147, zero_phase=False), h),
        noise_frames=4) for c in x]
    ref = np.stack([oracle.fir_direct(np.abs(b), he) * (np.pi / 2.0) for b in base])
    np.testing.assert_allclose(soak.composite_ref64(x).numpy(), ref, **F64)
    snr_all, snr_q2, snr_q4 = soak.composite_snrs(ref, y)
    assert snr_all >= soak.COMPOSITE_MIN_DB, snr_all
    assert snr_q4 >= snr_q2 - soak.FLAT_DB, (snr_q2, snr_q4)


@pytest.mark.parametrize("nfft,hop,n", soak.gate_fuzz_cases())
def test_gate_fuzz(nfft, hop, n):
    x = soak.gate_fuzz_input(nfft, hop, n)
    ref = np.stack([oracle.noise_gate(x[c], nfft=nfft, hop=hop) for c in range(2)])
    out = noise_gate_fused(torch.as_tensor(x), nfft=nfft, hop=hop).numpy()
    np.testing.assert_allclose(out, ref, **F64)

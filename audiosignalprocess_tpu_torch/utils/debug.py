"""Numerical-sanity helper: an SNR assertion for pinning any device path
to a float64 reference (the JAX package's ``utils.debug.assert_snr``)."""

from __future__ import annotations

from audiosignalprocess_tpu_torch.utils.metrics import snr_db


def assert_snr(ref, test, min_db: float = 60.0, what: str = "output") -> float:
    """Assert test matches ref to >= min_db SNR (numpy arrays or tensors on
    any device); returns the SNR."""
    s = snr_db(ref, test)
    if not s >= min_db:
        raise AssertionError(f"{what}: SNR {s:.1f} dB < {min_db} dB bound")
    return s

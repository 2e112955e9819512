"""Window functions (rect/Hann/Hamming/Blackman) for STFT and FIR design.

Conventions pinned by the JAX package's ``cpu_ref/oracle.window``:
``periodic=True`` (DFT-even) for STFT, symmetric for FIR design.  Values
are computed in float64 numpy at design time; ``window_np`` is a copy of
the oracle's function (the tests hold the two bit-equal), because the
JAX package cannot be imported without importing jax.
"""

from __future__ import annotations

import numpy as np
import torch

from audiosignalprocess_tpu_torch.utils.device import upload

KINDS = ("rect", "hann", "hamming", "blackman")


def window_np(kind: str, n: int, periodic: bool = True) -> np.ndarray:
    """Float64 numpy window of length n."""
    if kind == "rect":
        return np.ones(n, dtype=np.float64)
    if n == 1 and not periodic:
        # scipy convention: a 1-point symmetric window is [1.0], so
        # design_fir(numtaps=1) is the identity tap
        return np.ones(1, dtype=np.float64)
    denom = n if periodic else n - 1
    t = np.arange(n, dtype=np.float64)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * t / denom)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * t / denom)
    if kind == "blackman":
        return (
            0.42
            - 0.5 * np.cos(2.0 * np.pi * t / denom)
            + 0.08 * np.cos(4.0 * np.pi * t / denom)
        )
    raise ValueError(f"unknown window kind: {kind!r}")


def window(kind: str, n: int, periodic: bool = True,
           dtype: torch.dtype = torch.float32,
           device: torch.device | str | None = None) -> torch.Tensor:
    """Window of length n as a tensor (float64-accurate values, then cast)."""
    return upload(window_np(kind, n, periodic), dtype, device)

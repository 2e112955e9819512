"""Envelope follower / AM demodulation, oracle-pinned.

Full-wave rectify -> causal FIR lowpass, scaled by pi/2 (the sine-carrier
calibration).  ``hilbert_envelope`` is the analytic-signal variant by
rfft spectrum doubling.  Mirrors the JAX package's
``effects/envelope.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.fir import design_fir, fir_direct
from audiosignalprocess_tpu_torch.utils.device import upload


def envelope(x: torch.Tensor, h, history: torch.Tensor | None = None) -> torch.Tensor:
    """Rectify-and-smooth envelope; ``h`` = lowpass FIR taps."""
    return fir_direct(x.abs(), h, history=history) * (math.pi / 2.0)


def am_demod(x: torch.Tensor, h) -> torch.Tensor:
    """AM demodulation: envelope with the DC carrier removed (per channel)."""
    e = envelope(x, h)
    return e - e.mean(dim=-1, keepdim=True)


def default_envelope_fir(fs: float, fc: float = 50.0, numtaps: int = 129) -> np.ndarray:
    """Convenience lowpass design for envelope smoothing."""
    return design_fir(numtaps, 2.0 * fc / fs)


def hilbert_envelope(x: torch.Tensor, impl: str = fft_ops.DEFAULT_IMPL) -> torch.Tensor:
    """|analytic signal| via spectrum doubling (power-of-two length);
    ``impl``: the FFT implementation (``ops.fft``)."""
    n = x.shape[-1]
    spec = fft_ops.rfft(x, impl=impl)  # n//2+1 bins
    gain = np.full(n // 2 + 1, 2.0)
    gain[0] = 1.0
    gain[n // 2] = 1.0
    half = spec * upload(gain, x.dtype, x.device)
    full = torch.cat([half, half.new_zeros(x.shape[:-1] + (n - n // 2 - 1,))], dim=-1)
    return fft_ops.ifft(full, impl=impl).abs()

"""Device-independent helpers of the fused gate kernels.

Mirrors the helpers of the JAX package's ``kernels/gate_kernel.py`` that
the FIR -> gate chain needs: the 1/WOLA-norm vector and the noise-floor
prologue.  The fused gate kernel itself is not ported yet (ROADMAP
Queue 2).
"""

from __future__ import annotations

import numpy as np
import torch

from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.stft import wola_clamp


def inv_norm_rows(wv_np: np.ndarray, nfft: int, hop: int, nframes: int,
                  total_len: int) -> np.ndarray:
    """Full-length 1/WOLA-norm vector over a padded output (float64): head
    ramp, interior, tail ramp, then 1.0 in the padding past the output."""
    out_len = nfft + (nframes - 1) * hop
    w2 = wv_np ** 2
    norm_np = np.zeros(total_len)
    for k in range(nframes):
        norm_np[k * hop : k * hop + nfft] += w2
    inv = 1.0 / wola_clamp(norm_np[:out_len])
    return np.concatenate([inv, np.ones(total_len - out_len)])


def noise_floor(frames_windowed: torch.Tensor) -> torch.Tensor:
    """Per-bin noise floor, mean |rfft| over the frames axis:
    (..., frames, nfft) windowed frames -> (..., nfft/2+1)."""
    return fft_ops.rfft(frames_windowed).abs().mean(dim=-2)

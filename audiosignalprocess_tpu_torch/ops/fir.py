"""FIR design (host-side float64 numpy) and direct-form filtering.

``design_fir`` is a copy of the JAX package's ``cpu_ref/oracle.design_fir``
(windowed sinc, scipy.signal.firwin-compatible); the tests hold the two
bit-equal.  ``fir_direct`` is the causal direct-form filter
y[n] = sum_t h[t] x[n-t], output length == len(x); ``fused=True`` routes
it through the hand-written MAC kernel (``kernels/fir_kernel.fir_mac``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.ops.windows import window_np


def design_fir(numtaps: int, cutoff, window_kind: str = "hann",
               pass_zero: bool = True) -> np.ndarray:
    """Windowed-sinc linear-phase FIR taps (float64 numpy).

    cutoff: scalar (lowpass/highpass) or pair (bandpass/bandstop), in units
    of the Nyquist frequency.  pass_zero=True -> lowpass/bandstop;
    pass_zero=False -> highpass/bandpass.  Gain normalized to 1 at the band
    center (DC for pass_zero, band midpoint or Nyquist otherwise).
    """
    cutoff = np.atleast_1d(np.asarray(cutoff, dtype=np.float64))
    if np.any(cutoff <= 0) or np.any(cutoff >= 1):
        raise ValueError("cutoff must be in (0, 1) (Nyquist units)")
    bands = np.concatenate([[0.0], cutoff, [1.0]])
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    h = np.zeros(numtaps, dtype=np.float64)
    passband = pass_zero
    scale_freq = None
    for lo, hi in zip(bands[:-1], bands[1:]):
        if passband:
            # ideal bandpass [lo, hi): hi*sinc(hi*m) - lo*sinc(lo*m)
            h += hi * np.sinc(hi * m) - lo * np.sinc(lo * m)
            if scale_freq is None:
                scale_freq = 0.0 if lo == 0.0 else (1.0 if hi == 1.0 else 0.5 * (lo + hi))
        passband = not passband
    h *= window_np(window_kind, numtaps, periodic=False)
    c = np.cos(np.pi * m * scale_freq)
    s = np.sum(h * c)
    if abs(s) < 1e-8 * max(np.abs(h).max(), 1e-300) * numtaps:
        # e.g. even numtaps with gain at Nyquist (type-II highpass): the
        # normalization frequency has ~zero response; scipy.firwin raises too
        raise ValueError(
            f"invalid FIR design: numtaps={numtaps} has ~zero gain at the "
            f"normalization frequency (use odd numtaps for highpass/bandstop)"
        )
    h /= s
    return h


def fir_direct(x: torch.Tensor, h, history: torch.Tensor | None = None,
               fused: bool = False) -> torch.Tensor:
    """Causal direct-form FIR on the last axis, output length == len(x).

    ``history``: optional (..., T-1) previous input samples for streaming
    continuity (zeros when absent: a cold start, as the oracle).
    ``fused=True`` routes through ``kernels.fir_kernel.fir_mac`` (same
    semantics).  The plain path is ``conv1d`` with TF32 off: cuDNN runs
    float32 convolutions in TF32 by default, which keeps about three
    decimal digits.
    """
    if fused:
        from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac

        return fir_mac(x, h, history=history)
    h = np.asarray(h, dtype=np.float64)
    t = len(h)
    batch, n = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, 1, n)
    if history is not None and t > 1:  # t == 1: stateless
        xf = torch.cat([history.reshape(-1, 1, t - 1).to(x.dtype), xf], dim=-1)
    else:
        xf = F.pad(xf, (t - 1, 0))
    # correlation with reversed taps == causal convolution
    w = upload(h[::-1].copy(), x.dtype, x.device).reshape(1, 1, t)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv1d(xf, w)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.reshape(batch + (n,))

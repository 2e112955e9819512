"""FIR design (host-side float64 numpy).

``design_fir`` is a copy of the JAX package's ``cpu_ref/oracle.design_fir``
(windowed sinc, scipy.signal.firwin-compatible); the tests hold the two
bit-equal.  The direct-form ``fir_direct`` is not ported yet (ROADMAP
Queue 1).
"""

from __future__ import annotations

import numpy as np

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

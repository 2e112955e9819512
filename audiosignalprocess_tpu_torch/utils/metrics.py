"""SNR parity metric (same definition as the JAX package's utils.metrics)."""

from __future__ import annotations

import math

import numpy as np
import torch


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def snr_db(ref, test) -> float:
    """Signal-to-error ratio in dB; accepts numpy arrays or tensors on any device."""
    ref = _np64(ref)
    test = _np64(test)
    err = ref - test
    p_sig = float(np.sum(ref * ref))
    p_err = float(np.sum(err * err))
    if p_err == 0.0:
        return math.inf
    if p_sig == 0.0:
        # silent reference with nonzero error: infinitely bad, not a domain error
        return -math.inf
    return 10.0 * math.log10(p_sig / p_err)

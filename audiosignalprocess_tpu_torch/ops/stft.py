"""STFT analysis / ISTFT synthesis (WOLA), oracle-pinned conventions.

Frame k = x[k*hop : k*hop+nfft]: no center padding, no partial frames.
The ISTFT overlap-adds w*irfft(S) and divides by the summed squared
window, clamped below at ``WOLA_EDGE_REL`` of its peak (the JAX package's
``cpu_ref/oracle.wola_clamp``).  Output length = nfft + (frames-1)*hop.
"""

from __future__ import annotations

import numpy as np
import torch

from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.windows import window, window_np
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.validate import check

WOLA_EDGE_REL = 1e-3
"""Norm values below this fraction of the norm's peak divide by the clamp
instead, which tapers the few edge samples of a modified spectrum rather
than amplifying them by up to 1/w[i]."""


def wola_clamp(norm: np.ndarray) -> np.ndarray:
    """Clamped WOLA norm (float64; a copy of ``oracle.wola_clamp``)."""
    return np.maximum(norm, max(WOLA_EDGE_REL * float(np.max(norm)), 1e-12))


def num_frames(n: int, nfft: int, hop: int) -> int:
    check(n >= nfft, "signal shorter than one frame")
    return 1 + (n - nfft) // hop


def frame(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """(..., n) -> (..., frames, nfft) strided framing (a view)."""
    num_frames(x.shape[-1], nfft, hop)
    return x.unfold(-1, nfft, hop)


def stft(x: torch.Tensor, nfft: int, hop: int, window_kind: str = "hann",
         impl: str = fft_ops.DEFAULT_IMPL) -> torch.Tensor:
    """STFT -> (..., frames, nfft//2+1) complex."""
    w = window(window_kind, nfft, periodic=True, dtype=x.dtype, device=x.device)
    return fft_ops.rfft(frame(x, nfft, hop) * w, impl=impl)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., F, nfft) -> (..., nfft + (F-1)*hop) overlap-add.

    When hop divides nfft the output is viewed as rows of ``hop`` samples
    and each of the nfft/hop frame segments is added as one shifted slab.
    """
    nf, nfft = frames.shape[-2], frames.shape[-1]
    batch = frames.shape[:-2]
    nout = nfft + (nf - 1) * hop
    if nfft % hop == 0:
        r = nfft // hop
        fr = frames.reshape(batch + (nf, r, hop))
        acc = frames.new_zeros(batch + (nf + r - 1, hop))
        for j in range(r):
            acc[..., j : j + nf, :] += fr[..., :, j, :]
        return acc.reshape(batch + ((nf + r - 1) * hop,))[..., :nout]
    out = frames.new_zeros(batch + (nout,))
    for k in range(nf):
        out[..., k * hop : k * hop + nfft] += frames[..., k, :]
    return out


def _wola_norm(nf: int, nfft: int, hop: int, window_kind: str) -> np.ndarray:
    """Per-sample clamped sum of squared windows (float64, design time)."""
    w2 = window_np(window_kind, nfft, periodic=True) ** 2
    norm = np.zeros(nfft + (nf - 1) * hop)
    for k in range(nf):
        norm[k * hop : k * hop + nfft] += w2
    return wola_clamp(norm)


def istft(spec: torch.Tensor, nfft: int, hop: int, window_kind: str = "hann",
          impl: str = fft_ops.DEFAULT_IMPL) -> torch.Tensor:
    """WOLA inverse STFT.  Output length = nfft + (frames-1)*hop: zeros of
    length nfft - hop for zero frames, before any transform."""
    nf = spec.shape[-2]
    if nf == 0:
        return torch.zeros(spec.shape[:-2] + (nfft - hop,), dtype=spec.real.dtype,
                           device=spec.device)
    t = fft_ops.irfft(spec, nfft, impl=impl)
    w = window(window_kind, nfft, periodic=True, dtype=t.dtype, device=t.device)
    y = overlap_add(t * w, hop)
    inv = upload(1.0 / _wola_norm(nf, nfft, hop, window_kind), t.dtype, t.device)
    return y * inv

"""The plain float64 reference of the chains the benchmark runs.

Written from the pinned conventions of the float64 oracle (a causal FIR,
a causal polyphase resampler, the STFT noise gate with WOLA synthesis,
the envelope follower) in plain PyTorch, device-agnostic.  It imports
nothing of the program under test: the taps are designed here
(``design_fir``, ``resample_filter``, frozen copies of the oracle's) and
handed to both sides.

Every function takes ``q``, a rounding applied to each stage's inputs,
taps and outputs and to the spectrum: the identity for the reference,
bfloat16 rounding for the control (``portbench.compare``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

WOLA_EDGE_REL = 1e-3
"""The WOLA norm is clamped below at this share of its peak (absolute
floor 1e-12), as the oracle's ``wola_clamp``."""


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def window(kind: str, n: int, periodic: bool = True) -> np.ndarray:
    """Window function, float64: rect, hann, hamming or blackman."""
    if kind == "rect":
        return np.ones(n, dtype=np.float64)
    if n == 1 and not periodic:
        return np.ones(1, dtype=np.float64)
    denom = n if periodic else n - 1
    t = np.arange(n, dtype=np.float64)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * t / denom)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * t / denom)
    if kind == "blackman":
        return (0.42 - 0.5 * np.cos(2.0 * np.pi * t / denom)
                + 0.08 * np.cos(4.0 * np.pi * t / denom))
    raise ValueError(f"unknown window kind: {kind!r}")


def design_fir(numtaps: int, cutoff, window_kind: str = "hann",
               pass_zero: bool = True) -> np.ndarray:
    """Windowed-sinc linear-phase FIR (firwin-compatible), cutoff in
    Nyquist units, gain 1 at the band centre."""
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
            h += hi * np.sinc(hi * m) - lo * np.sinc(lo * m)
            if scale_freq is None:
                scale_freq = 0.0 if lo == 0.0 else (1.0 if hi == 1.0 else 0.5 * (lo + hi))
        passband = not passband
    h *= window(window_kind, numtaps, periodic=False)
    s = np.sum(h * np.cos(np.pi * m * scale_freq))
    if abs(s) < 1e-8 * max(np.abs(h).max(), 1e-300) * numtaps:
        raise ValueError(f"numtaps={numtaps} has ~zero gain at the normalization frequency")
    return h / s


def resample_filter(up: int, down: int, half_width: int = 10,
                    window_kind: str = "hann") -> np.ndarray:
    """Prototype lowpass of an up/down resampler: windowed sinc at
    1/max(up, down), 2*half_width*max(up, down)+1 taps, gain up."""
    m = max(up, down)
    return design_fir(2 * half_width * m + 1, 1.0 / m, window_kind=window_kind) * up


def _taps(h: np.ndarray, like: torch.Tensor, q) -> torch.Tensor:
    return q(torch.as_tensor(np.asarray(h, np.float64), dtype=like.dtype, device=like.device))


def fir(x: torch.Tensor, h: np.ndarray, q=_same) -> torch.Tensor:
    """Causal FIR, y[n] = sum_t h[t] x[n-t], output length len(x), by one
    zero-padded FFT convolution per row."""
    n, t = x.shape[-1], len(h)
    nfft = 1 << max(1, (n + t - 1 - 1).bit_length())
    hf = torch.fft.rfft(_taps(h, x, q), nfft)
    return q(torch.fft.irfft(torch.fft.rfft(q(x), nfft) * hf, nfft)[..., :n])


def resample(x: torch.Tensor, up: int, down: int, h: np.ndarray, q=_same) -> torch.Tensor:
    """Causal polyphase resampler: y[j] = sum_k h[p_j + up*k] x[m_j - k],
    j*down = m_j*up + p_j, zero before the start; ceil(n*up/down)
    outputs."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    n = x.shape[-1]
    nout = -(-n * up // down)
    nk = -(-len(h) // up)
    hp = np.zeros(nk * up)
    hp[: len(h)] = h
    bank = _taps(hp.reshape(nk, up).T, x, q)  # bank[p, k] = h[p + up*k]
    j = torch.arange(nout, device=x.device)
    m = (j * down) // up
    p = (j * down) % up
    xp = torch.cat([x.new_zeros(x.shape[:-1] + (nk - 1,)), q(x)], dim=-1)
    out = x.new_zeros(x.shape[:-1] + (nout,))
    for k in range(nk):
        out += bank[p, k] * xp.index_select(-1, m - k + nk - 1)
    return q(out)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum frames (..., F, nfft) placed hop apart: nfft + (F-1)*hop."""
    f, nfft = frames.shape[-2], frames.shape[-1]
    r = nfft // hop
    out = frames.new_zeros(frames.shape[:-2] + ((f + r - 1) * hop,))
    parts = frames.reshape(frames.shape[:-2] + (f, r, hop))
    for i in range(r):
        out[..., i * hop : (i + f) * hop] += parts[..., i, :].reshape(frames.shape[:-2] + (f * hop,))
    return out


def gate_spectrum(x: torch.Tensor, nfft: int, hop: int, window_kind: str, q=_same):
    """The windowed frames' spectra (..., F, nfft/2+1): frames at k*hop,
    no padding, no partial frame."""
    w = torch.as_tensor(window(window_kind, nfft, True), dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(q(x).unfold(-1, nfft, hop) * w)
    return torch.complex(q(spec.real), q(spec.imag))


def gate_floor(spec: torch.Tensor, noise_frames: int) -> torch.Tensor:
    """Per-bin noise floor: the mean magnitude of the first frames."""
    return spec[..., :noise_frames, :].abs().mean(dim=-2, keepdim=True)


def noise_gate(x: torch.Tensor, nfft: int, hop: int, threshold_db: float,
               reduction_db: float, noise_frames: int, window_kind: str = "hann",
               floor: torch.Tensor | None = None, q=_same):
    """The STFT noise gate, zero-padded back to the input length:
    (output, floor).  ``floor`` (..., 1, bins) replaces the floor of this
    signal's own first frames (a segment cut from a longer stream)."""
    n = x.shape[-1]
    spec = gate_spectrum(x, nfft, hop, window_kind, q)
    mag = spec.abs()
    if floor is None:
        floor = gate_floor(spec, noise_frames)
    mask = torch.where(mag > floor * 10.0 ** (threshold_db / 20.0), 1.0,
                       10.0 ** (-reduction_db / 20.0))
    w = torch.as_tensor(window(window_kind, nfft, True), dtype=x.dtype, device=x.device)
    frames = torch.fft.irfft(spec * mask, nfft) * w
    y = _overlap_add(frames, hop)
    norm = _overlap_add((w * w).expand(frames.shape[-2], nfft), hop)
    norm = torch.clamp(norm, min=max(WOLA_EDGE_REL * float(norm.max()), 1e-12))
    y = q(y / norm)
    return torch.nn.functional.pad(y, (0, n - y.shape[-1])), floor


def envelope(x: torch.Tensor, h: np.ndarray, scale: float = math.pi / 2.0,
             q=_same) -> torch.Tensor:
    """Full-wave rectify, causal FIR lowpass, times ``scale``."""
    return q(fir(x.abs(), h, q) * scale)


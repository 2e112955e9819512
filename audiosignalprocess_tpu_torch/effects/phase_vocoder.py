"""Phase-vocoder time stretch and pitch shift, oracle-pinned.

Mirrors the JAX package's ``effects/phase_vocoder.py``.  Time stretch:
output frame i samples analysis position t_i = i*rate (frames), linearly
interpolating magnitudes and advancing the phase by the measured
inter-frame increment.  Pitch shift = time stretch by 1/factor + a
polyphase resample by the rational approximation of the factor.

Rotor phase accumulation: the synthesis phase matters only mod 2*pi, and
the per-frame advance e^{i*dphi} equals unit(s1*conj(s0)) exactly, so the
phase is carried as a product of unit rotors (planar re/im) instead of a
sum of angles: no angle extraction, no trig, no large float32 sums (the
angle-sum form of the oracle reaches only ~52 dB in float32).  The
product over frames is a log-depth prefix scan in plain torch ops
(``cumrotor``); the streaming step (``kernels/stretch_kernel``) carries
the running product across blocks.

Frame grids are computed with numpy on the host, as the JAX package does:
``np.arange(0, nf - 1, rate)`` for a float rate, integer ``(i*p)//q`` and
``(i*p) % q`` for a rational one (``stretch_steps_rational``).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.resample import resample_poly
from audiosignalprocess_tpu_torch.ops.stft import istft, num_frames, stft
from audiosignalprocess_tpu_torch.utils.device import upload


def _wrap(p: torch.Tensor) -> torch.Tensor:
    return p - 2.0 * torch.pi * torch.round(p / (2.0 * torch.pi))


def unit_rotor(zr: torch.Tensor, zi: torch.Tensor, eps: float = 1e-36):
    """(zr, zi)/|z|, mapping |z|^2 <= eps to the neutral rotor 1+0j (a zero
    product must not annihilate the running phase product)."""
    m2 = zr * zr + zi * zi
    ok = m2 > eps
    inv = torch.where(ok, torch.rsqrt(torch.where(ok, m2, 1.0)), 0.0)
    return torch.where(ok, zr * inv, 1.0), torch.where(ok, zi * inv, 0.0)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def cumrotor(ur: torch.Tensor, ui: torch.Tensor, axis: int = -2):
    """Inclusive cumulative product of planar rotors along ``axis``:
    a log-depth (Hillis-Steele) scan, each pass multiplying every element
    by the one ``s`` places before it, s = 1, 2, 4, ..."""
    n = ur.shape[axis]
    cr, ci = ur, ui
    s = 1
    while s < n:
        pr, pi = _cmul(cr.narrow(axis, 0, n - s), ci.narrow(axis, 0, n - s),
                       cr.narrow(axis, s, n - s), ci.narrow(axis, s, n - s))
        cr = torch.cat([cr.narrow(axis, 0, s), pr], dim=axis)
        ci = torch.cat([ci.narrow(axis, 0, s), pi], dim=axis)
        s *= 2
    return cr, ci


def _rotor_phase(spec: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor):
    """Exclusive prefix rotors P_i = unit(spec[0]) * prod_{j<i}
    unit(s1_j conj(s0_j)) as planar (Pr, Pi), frames on axis -2."""
    s0r, s0i, s1r, s1i = s0.real, s0.imag, s1.real, s1.imag
    ur, ui = unit_rotor(s1r * s0r + s1i * s0i, s1i * s0r - s1r * s0i)
    cr, ci = cumrotor(ur, ui)
    er = torch.cat([torch.ones_like(cr[..., :1, :]), cr[..., :-1, :]], dim=-2)
    ei = torch.cat([torch.zeros_like(ci[..., :1, :]), ci[..., :-1, :]], dim=-2)
    z0r, z0i = unit_rotor(spec[..., 0:1, :].real, spec[..., 0:1, :].imag)
    return _cmul(z0r, z0i, er, ei)


def _stretch_at(spec: torch.Tensor, k: np.ndarray, frac: np.ndarray) -> torch.Tensor:
    """Shared stretch body: interpolate magnitudes at analysis positions
    k + frac and rebuild the phase with the exclusive prefix rotors (the
    expected-advance term omega cancels exactly in the rotor form).  Where
    the float grid of ``stretch_spec`` lands on the last frame (k = nf - 1,
    frac = 0), its neighbour is clamped to that frame: the interpolation is
    exact there, where the JAX package's ``jnp.take`` fills NaN."""
    idx = torch.as_tensor(k, dtype=torch.int64, device=spec.device)
    s0 = spec.index_select(-2, idx)
    s1 = spec.index_select(-2, (idx + 1).clamp(max=spec.shape[-2] - 1))
    f = upload(frac, spec.real.dtype, spec.device)[:, None]
    mag = (1.0 - f) * s0.abs() + f * s1.abs()
    pr, pi = _rotor_phase(spec, s0, s1)
    return torch.complex(mag * pr, mag * pi)


def stretch_spec(spec: torch.Tensor, rate: float, nfft: int, hop: int) -> torch.Tensor:
    """Resample an STFT along frames with phase accumulation."""
    nf = spec.shape[-2]
    steps = np.arange(0, nf - 1, rate)
    k = np.floor(steps).astype(np.int64)
    return _stretch_at(spec, k, steps - k)


def stretch_steps_rational(nf: int, p: int, q: int):
    """Exact integer analysis positions for rate p/q: output frame i maps
    to t_i = i*p/q, emitted while t_i < nf-1.  Returns (k, frac_num) with
    k_i = (i*p)//q and frac_i = (i*p % q)/q: the integer-exact version of
    ``np.arange(0, nf-1, rate)``, whose float steps can land one ulp below
    an integer and pick the wrong frame."""
    nof = 0 if nf < 2 else (((nf - 1) * q - 1) // p) + 1
    i = np.arange(nof)
    return (i * p) // q, (i * p) % q


def stretch_spec_rational(spec: torch.Tensor, p: int, q: int, nfft: int,
                          hop: int) -> torch.Tensor:
    """``stretch_spec`` at the exact rational rate p/q (the frame grid the
    streaming ``StretchStage`` shares)."""
    k, fnum = stretch_steps_rational(spec.shape[-2], p, q)
    return _stretch_at(spec, k, fnum / q)


def time_stretch(x: torch.Tensor, rate: float, nfft: int = 1024, hop: int = 256,
                 window_kind: str = "hann", impl: str = fft_ops.DEFAULT_IMPL) -> torch.Tensor:
    """Phase-vocoder time stretch (rate > 1 speeds up).  On a CUDA float32
    tensor the default ``impl`` runs one ``rfft_stockham`` and one
    ``irfft_stockham``."""
    spec = stft(x, nfft, hop, window_kind, impl=impl)
    out = stretch_spec(spec, rate, nfft, hop)
    return istft(out, nfft, hop, window_kind, impl=impl)


def pitch_shift(x: torch.Tensor, semitones: float, nfft: int = 1024, hop: int = 256,
                window_kind: str = "hann", resample_quant: int = 128,
                impl: str = fft_ops.DEFAULT_IMPL) -> torch.Tensor:
    """Pitch shift by semitones; the output has about the input's
    duration.  float32 resamples through ``resample_mac`` (the kernel on
    a CUDA tensor), float64 through the plain ``resample_poly``."""
    factor = 2.0 ** (semitones / 12.0)
    fr = Fraction(factor).limit_denominator(resample_quant)
    up, down = fr.denominator, fr.numerator
    y = time_stretch(x, 1.0 / factor, nfft, hop, window_kind, impl=impl)
    return resample_poly(y, up, down, fused=y.dtype != torch.float64)


def output_frames(n: int, rate: float, nfft: int, hop: int) -> int:
    """Output frame count of ``stretch_spec`` for input length n."""
    return len(np.arange(0, num_frames(n, nfft, hop) - 1, rate))

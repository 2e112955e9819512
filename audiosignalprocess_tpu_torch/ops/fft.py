"""FFT family with the JAX package's pinned conventions.

Forward is unnormalized, the inverse scales by 1/N, ``rfft`` returns the
N/2+1 bins 0..N/2, and every transform runs on the last axis, whose
length must be a power of two.  ``impl="torch"`` (torch.fft) is the one
implementation so far; the structural ``radix2``/``splitradix`` impls
and the standalone FFT kernels are still to be ported (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from audiosignalprocess_tpu_torch.utils.validate import check

DEFAULT_IMPL = "torch"


def _check_impl(impl: str) -> None:
    if impl in ("radix2", "splitradix"):
        raise NotImplementedError(
            f"impl={impl!r} is not ported yet (ROADMAP Queue 1: FFT impls)")
    check(impl == "torch", f"unknown FFT impl {impl!r}")


def _check_pow2(n: int, least: int = 1) -> None:
    check(n >= least and n & (n - 1) == 0,
          f"power-of-two length >= {least} required, got {n}")


def fft(x: torch.Tensor, impl: str = DEFAULT_IMPL) -> torch.Tensor:
    """Forward FFT on the last axis (unnormalized)."""
    _check_impl(impl)
    _check_pow2(x.shape[-1])
    return torch.fft.fft(x)


def ifft(x: torch.Tensor, impl: str = DEFAULT_IMPL) -> torch.Tensor:
    """Inverse FFT on the last axis, scaled 1/N."""
    _check_impl(impl)
    _check_pow2(x.shape[-1])
    return torch.fft.ifft(x)


def rfft(x: torch.Tensor, impl: str = DEFAULT_IMPL) -> torch.Tensor:
    """Real FFT on the last axis: N/2+1 bins."""
    _check_impl(impl)
    check(not x.is_complex(),
          "rfft requires a real-valued input (use fft for complex signals)")
    _check_pow2(x.shape[-1], least=2)
    return torch.fft.rfft(x)


def irfft(spec: torch.Tensor, n: int, impl: str = DEFAULT_IMPL) -> torch.Tensor:
    """Inverse real FFT: n real samples from n/2+1 bins (1/N scaling)."""
    _check_impl(impl)
    _check_pow2(n, least=2)
    return torch.fft.irfft(spec, n)

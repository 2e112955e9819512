"""The yardstick of the roofline shares: the card's published peaks and
frozen copies of the operation counts the port's smoke suite used
(``fft_flops``, ``chain_flops``, ``set_bound``), so that no change to the
program moves them."""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12
"""H100 SXM HBM3, NVIDIA's data sheet, at the full 700 W power limit."""
PEAK_F32_FLOP_S = 67e12
"""H100 SXM float32 outside the tensor cores, the same data sheet."""


def fft_flops(n: int, transforms: float = 1.0) -> float:
    """Nominal float32 operations of complex n-point radix-2 FFTs,
    5 n log2 n each (a real transform of n points counts half)."""
    return transforms * 5.0 * n * math.log2(n)


def chain_flops(channels: int, samples: float, frames: float, nfft: int, taps: int) -> float:
    """Overlap-save FIR blocks and gate frames of ``channels`` x
    ``samples``: each block and each frame is a forward and an inverse
    real nfft-point transform (one complex transform's worth).  A whole
    file rounds the FIR's blocks up; a stream's block passes a fraction."""
    return channels * fft_flops(nfft, samples / (nfft - (taps - 1)) + frames)


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 peak, and which
    of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

"""SNR parity metric and the GPU roofline model (the JAX package's
``utils.metrics``, with the card's figures in place of the TPU's).

Batched FFTs are memory-bound, so their speed of light is each sample
moved in and out of device memory once; the chip's figures are the
published peaks that ``chip_smoke.py`` reads its bounds against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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


@dataclass(frozen=True)
class ChipSpec:
    """Per-card ceilings used for roofline accounting."""

    name: str
    hbm_gbps: float  # device memory bandwidth, GB/s
    f32_tflops: float  # float32 peak outside the tensor cores
    bf16_tflops: float  # dense bf16 tensor-core peak


# NVIDIA's data sheet, the SXM part at its full power limit (700 W)
H100_SXM = ChipSpec(name="h100-sxm", hbm_gbps=3350.0, f32_tflops=67.0, bf16_tflops=989.0)


def detect_chip() -> ChipSpec:
    """The ChipSpec of card 0, named by ``torch.cuda.get_device_name(0)``
    (which raises where there is no card).  The H100 SXM is the one model,
    whatever the name: it only sets the roofline's denominators."""
    torch.cuda.get_device_name(0)
    return H100_SXM


def fft_roofline_bytes(batch: int, n: int, dtype_bytes: int = 4,
                       complex_io: bool = False) -> int:
    """Least device-memory traffic of a batched FFT: each element read and
    written once."""
    width = 2 * dtype_bytes if complex_io else dtype_bytes
    return 2 * batch * n * width


def roofline_time_s(bytes_moved: int, chip: ChipSpec) -> float:
    """Seconds to move ``bytes_moved`` at the card's memory rate."""
    return bytes_moved / (chip.hbm_gbps * 1e9)

"""The short soaks of tests/integration/test_soak_short.py and the gate
cases of tests/kernels/test_fuzz_params.py for the port: their inputs,
chains and bars, with the soaks' float64 references computed by the
port's plain PyTorch path (``tests/test_torch_soak_fuzz.py`` holds those
to the oracle on the CPU; ``tests/test_torch_cuda.py`` runs the kernels
against them on the card).  Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
from audiosignalprocess_tpu_torch.effects.phase_vocoder import time_stretch
from audiosignalprocess_tpu_torch.ops.fir import design_fir, fir_direct
from audiosignalprocess_tpu_torch.ops.resample import resample_poly
from audiosignalprocess_tpu_torch.pipeline import Chain, ResFIRGateStage, StretchStage
from audiosignalprocess_tpu_torch.utils.metrics import snr_db

STRETCH_BLOCK, STRETCH_BLOCKS = 2048, 32
STRETCH_MIN_DB = 95.0
COMPOSITE_BLOCK, COMPOSITE_BLOCKS = 2 * 588, 24
COMPOSITE_MIN_DB = 60.0
FLAT_DB = 15.0  # the last quarter within this of the second


def stretch_input() -> np.ndarray:
    n = STRETCH_BLOCK * STRETCH_BLOCKS
    rng = np.random.default_rng(11)
    t = np.arange(n) / 48000.0
    return (0.3 * rng.standard_normal((2, n))
            + 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.sin(2 * np.pi * 0.3 * t)
            ).astype(np.float32)


def stretch_chain() -> Chain:
    c = Chain([StretchStage(p=4, q=3, nfft=1024, hop=256, fused=True)])
    c.build()
    return c


def stretch_ref64(x: np.ndarray) -> torch.Tensor:
    """The whole-file float64 vocoder (oracle.time_stretch's conventions)."""
    return time_stretch(torch.as_tensor(x, dtype=torch.float64), 4 / 3, 1024, 256,
                        impl="torch")


def stretch_snr(ref, y) -> float:
    """The soak's reading: the stream against the whole-file vocoder, past
    the last 2048 samples of the shorter."""
    m = min(y.shape[-1], ref.shape[-1]) - 2048
    return snr_db(ref[:, :m], y[:, :m])


def composite_taps() -> tuple[np.ndarray, np.ndarray]:
    return design_fir(64, 0.3), design_fir(129, 0.05)


def composite_input() -> np.ndarray:
    n = COMPOSITE_BLOCK * COMPOSITE_BLOCKS
    rng = np.random.default_rng(11)
    x = (0.01 * rng.standard_normal((2, n))).astype(np.float32)
    lo, hi = n // 8, n // 4
    x[:, lo:hi] += np.sin(2 * np.pi * 440 * np.arange(hi - lo) / 44100).astype(np.float32)
    return x


def composite_chain() -> Chain:
    h, he = composite_taps()
    c = Chain([ResFIRGateStage(up=160, down=147, h=h, nfft=1024, hop=256, noise_frames=4,
                               env_h=he)])
    c.build()
    return c


def composite_ref64(x: np.ndarray) -> torch.Tensor:
    """Causal resample -> FIR -> gate -> envelope (|.| -> FIR -> pi/2), the
    plain float64 ops one after another."""
    h, he = composite_taps()
    x64 = torch.as_tensor(x, dtype=torch.float64)
    base = noise_gate(fir_direct(resample_poly(x64, 160, 147, zero_phase=False), h),
                      noise_frames=4, impl="torch")
    return fir_direct(base.abs(), he) * (math.pi / 2.0)


def composite_snrs(ref, y) -> tuple[float, float, float]:
    """(overall, second quarter, last quarter): the first quarter holds the
    burst's onset and is left out of the flatness check."""
    m = min(y.shape[-1], ref.shape[-1])
    q = m // 4
    return (snr_db(ref[:, :m], y[:, :m]), snr_db(ref[:, q:2 * q], y[:, q:2 * q]),
            snr_db(ref[:, 3 * q:m], y[:, 3 * q:m]))


def gate_fuzz_cases(k: int = 6) -> list[tuple[int, int, int]]:
    """The reference's ``_cases_gate``: seed 2027, six nfft/hop pairs,
    24 to 79 frames and a ragged tail."""
    rng = np.random.default_rng(2027)
    out = []
    combos = [(256, 128), (512, 128), (512, 256), (1024, 256), (1024, 512), (2048, 512)]
    for _ in range(k):
        nfft, hop = combos[rng.integers(0, len(combos))]
        nf = int(rng.integers(24, 80))
        n = nfft + (nf - 1) * hop + int(rng.integers(0, hop))
        out.append((nfft, hop, n))
    return out


def gate_fuzz_input(nfft: int, hop: int, n: int) -> np.ndarray:
    """Two channels of noise with a tone in the middle third (float64)."""
    rng = np.random.default_rng(nfft + n)
    x = 0.01 * rng.standard_normal((2, n))
    lo, hi = n // 3, 2 * (n // 3)
    x[:, lo:hi] += np.sin(np.arange(hi - lo))
    return x

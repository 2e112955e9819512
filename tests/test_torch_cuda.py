"""The port's CUDA kernels vs their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; every test skips without a GPU.  Imports
neither jax nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
    fir_noise_gate_fused, fir_noise_gate_ref,
)
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.utils.metrics import snr_db

pytestmark = pytest.mark.requires_cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tone_burst(rng, c, n, fs=48000):
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.25 * n / fs) & (t < 0.7 * n / fs),
                  np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


@pytest.mark.parametrize("release,taps,hop", [
    (0.0, 64, 256), (0.6, 64, 256), (0.0, 384, 256), (0.0, 30, 512),
    (0.6, 64, 128),
])
def test_fir_noise_gate_kernel_vs_plain(card, release, taps, hop):
    """float32 kernel vs the float64 plain version on the same card:
    exact output length, finite, >= 60 dB (the gate's hard thresholds
    flip a few borderline bins under float32 rounding), one launch."""
    rng = np.random.default_rng(50)
    x = torch.as_tensor(_tone_burst(rng, 3, 40000), device=card)
    h = design_fir(taps, 0.2 if taps == 384 else 0.3)
    before = fir_noise_gate_fused.launches
    out = fir_noise_gate_fused(x.float(), h, hop=hop, release=release)
    torch.cuda.synchronize()
    assert fir_noise_gate_fused.launches == before + 1
    ref = fir_noise_gate_ref(x, h, hop=hop, release=release)
    assert out.shape == ref.shape == (3, 1024 + ((40000 - 1024) // hop) * hop)
    assert bool(torch.isfinite(out).all())
    assert snr_db(ref, out) >= 60.0


def test_float64_on_card_raises(card):
    with pytest.raises(ValueError, match="float32"):
        fir_noise_gate_fused(torch.zeros(1, 8192, dtype=torch.float64, device=card),
                             design_fir(64, 0.3))

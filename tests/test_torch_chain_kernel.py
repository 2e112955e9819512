"""The port's fused FIR+gate chain vs the JAX package's Pallas kernel
(interpret mode) and the float64 oracle.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel
itself is checked on the card by tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.kernels import chain_kernel as jax_chain
from audiosignalprocess_tpu_torch.kernels import chain_kernel
from audiosignalprocess_tpu_torch.kernels.chain_kernel import (
    fir_noise_gate_fused, fir_noise_gate_ref,
)
from audiosignalprocess_tpu_torch.utils.metrics import snr_db


def _mk(rng, c, n, fs=48000):
    """Tone burst in low noise (tests/kernels/test_chain_kernel.py)."""
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.25 * n / fs) & (t < 0.7 * n / fs),
                  np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


def _oracle_chain(x, h, **kw):
    return np.stack([oracle.noise_gate(oracle.fir_direct(xc, h), **kw) for xc in x])


@pytest.mark.parametrize("n,taps,release", [
    (48128, 64, 0.0),
    (16384 + 256 * 3, 64, 0.0),
    (16384 + 256 * 3, 64, 0.6),
    (32768, 384, 0.0),
])
def test_vs_jax_kernel_f64(n, taps, release):
    rng = np.random.default_rng(47)
    x = _mk(rng, 2, n)
    h = oracle.design_fir(taps, 0.2 if taps == 384 else 0.3)
    ref = np.asarray(jax_chain.fir_noise_gate_fused(
        x, h, release=release, frames_per_step=8, batch_tile=2))
    out = fir_noise_gate_fused(torch.as_tensor(x), h, release=release)
    assert out.dtype == torch.float64
    assert out.shape == ref.shape == (2, 1024 + ((n - 1024) // 256) * 256)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-8, atol=1e-10)


def test_f32_snr_vs_oracle():
    rng = np.random.default_rng(48)
    x = _mk(rng, 4, 32768).astype(np.float32)
    h = oracle.design_fir(64, 0.3)
    ref = _oracle_chain(x.astype(np.float64), h)
    out = fir_noise_gate_fused(torch.as_tensor(x), h)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert snr_db(ref, out) >= 60.0


def test_cpu_runs_plain_version_without_launch():
    rng = np.random.default_rng(49)
    x = torch.as_tensor(_mk(rng, 1, 8192).astype(np.float32))
    h = oracle.design_fir(64, 0.3)
    before = fir_noise_gate_fused.launches
    out = fir_noise_gate_fused(x, h, noise_frames=4)
    assert fir_noise_gate_fused.launches == before
    assert torch.equal(out, fir_noise_gate_ref(x, h, noise_frames=4))


@pytest.mark.parametrize("kw,msg", [
    (dict(nfft=1000), "power of two"),
    (dict(hop=300), "must divide"),
    (dict(taps=1025), "taps-1"),
    (dict(n=2048), "too short"),
    (dict(noise_frames=99), "noise_frames"),
])
def test_guards(kw, msg):
    n = kw.pop("n", 8192)
    h = oracle.design_fir(kw.pop("taps", 64), 0.3)
    with pytest.raises(ValueError, match=msg):
        fir_noise_gate_fused(torch.zeros(1, n), h, **kw)


def test_other_devices_raise():
    h = oracle.design_fir(64, 0.3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fir_noise_gate_fused(torch.zeros(1, 8192, device="meta"), h)


def test_headline_geometry_fits_shared_memory():
    geo = chain_kernel.regs_geometry(1024, 256, 64)
    assert geo["mf"] == 21
    assert geo["smem"] <= chain_kernel.SMEM_LIMIT // 2  # two CTAs per SM
    # the halo of nfft/hop - 1 = 63 frames at hop 16 fills whole batches of 8
    assert (chain_kernel.regs_geometry(1024, 16, 384)["mf"] + 63) % 8 == 0

"""Port ops vs the JAX package's impl="xla" counterparts, float64 on CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.effects.noise_gate import noise_gate as jax_noise_gate
from audiosignalprocess_tpu.ops import fft as jax_fft
from audiosignalprocess_tpu.ops import overlap_save as jax_os
from audiosignalprocess_tpu.ops import stft as jax_stft
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
from audiosignalprocess_tpu_torch.ops import fft, stft
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save

TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture()
def rng():
    return np.random.default_rng(11)


def _both(a):
    return torch.as_tensor(a), jnp.asarray(a)


def _close(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("n", (2, 16, 1024))
def test_fft_family(rng, n):
    x = rng.standard_normal((3, n))
    xt, xj = _both(x)
    _close(fft.rfft(xt), jax_fft.rfft(xj, impl="xla"))
    spec = fft.rfft(xt)
    _close(fft.irfft(spec, n), jax_fft.irfft(jnp.asarray(spec.numpy()), n, impl="xla"))
    z = x + 1j * rng.standard_normal((3, n))
    zt, zj = _both(z)
    _close(fft.fft(zt), jax_fft.fft(zj, impl="xla"))
    _close(fft.ifft(zt), jax_fft.ifft(zj, impl="xla"))


def test_fft_guards(rng):
    with pytest.raises(ValueError):
        fft.rfft(torch.zeros(3, 24, dtype=torch.float64))
    with pytest.raises(ValueError):
        fft.rfft(torch.zeros(8, dtype=torch.complex128))
    # impl="matmul", the four-step product form, equals the JAX package's
    z = rng.standard_normal((3, 64)) + 1j * rng.standard_normal((3, 64))
    zt, zj = _both(z)
    _close(fft.fft(zt, impl="matmul"), jax_fft.fft(zj, impl="matmul"))


@pytest.mark.parametrize("nfft,hop,n", [(1024, 256, 6000), (256, 64, 1000),
                                        (128, 48, 777)])
def test_stft_istft(rng, nfft, hop, n):
    x = rng.standard_normal((2, n))
    xt, xj = _both(x)
    spec = stft.stft(xt, nfft, hop)
    _close(spec, jax_stft.stft(xj, nfft, hop, impl="xla"))
    assert spec.shape[-2] == stft.num_frames(n, nfft, hop) == 1 + (n - nfft) // hop
    y = stft.istft(spec, nfft, hop)
    _close(y, jax_stft.istft(jnp.asarray(spec.numpy()), nfft, hop, impl="xla"))
    assert y.shape[-1] == nfft + (spec.shape[-2] - 1) * hop


@pytest.mark.parametrize("taps,nfft,n", [(64, 1024, 5000), (384, 1024, 3000),
                                         (1, 16, 100), (17, 32, 33)])
def test_overlap_save(rng, taps, nfft, n):
    x = rng.standard_normal((2, n))
    h = oracle.design_fir(taps, 0.3)
    xt, xj = _both(x)
    y = overlap_save(xt, h, nfft)
    assert y.shape == (2, n)
    _close(y, jax_os.overlap_save(xj, h, nfft, impl="xla"))
    np.testing.assert_allclose(y[0].numpy(), oracle.fir_direct(x[0], h), **TOL)
    hist = rng.standard_normal((2, taps - 1))
    _close(overlap_save(xt, h, nfft, history=torch.as_tensor(hist)),
           jax_os.overlap_save(xj, h, nfft, history=jnp.asarray(hist), impl="xla"))


@pytest.mark.parametrize("release", (0.0, 0.6))
def test_noise_gate(rng, release):
    n = 12000
    t = np.arange(n) / 48000
    x = 0.01 * rng.standard_normal((2, n)) + np.where(
        t > 0.1, np.sin(2 * np.pi * 440.0 * t), 0.0)
    xt, xj = _both(x)
    y = noise_gate(xt, 1024, 256, noise_frames=4, release=release)
    ref = jax_noise_gate(xj, 1024, 256, noise_frames=4, release=release,
                         impl="xla")
    _close(y, ref)
    np.testing.assert_allclose(
        y[1].numpy(), oracle.noise_gate(x[1], 1024, 256, noise_frames=4,
                                        release=release), **TOL)

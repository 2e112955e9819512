"""Twins of the ``impl="matmul"`` cases of tests/unit/test_fft.py and
tests/unit/test_stft.py for the port: the four-step FFT in plain torch
(two dense DFT products around a twiddle, float64 tables, TF32 off).

Each case holds the port to the JAX test's own bar against the oracle and
to the JAX package's ``impl="matmul"`` on the same input (float64:
rtol 1e-10 / atol 1e-12, the sum orders differ; float32: >= 100 dB).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops import fft as jax_fft
from audiosignalprocess_tpu.ops import stft as jax_stft
from audiosignalprocess_tpu_torch.ops import fft, stft

SIZES = (2, 4, 8, 64, 256, 1024, 4096)
TOL = dict(rtol=1e-10, atol=1e-12)


def _snr_c(ref, test):
    err = np.abs(ref - np.asarray(test))
    e = np.sum(err ** 2)
    return np.inf if e == 0 else 10.0 * np.log10(np.sum(np.abs(ref) ** 2) / e)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def _jax(fn, x, *args):
    return np.asarray(fn(jnp.asarray(x), *args, impl="matmul"))


class TestMatmulFFT:
    @pytest.mark.parametrize("n", SIZES)
    def test_fft_f64(self, rng, n):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        out = fft.fft(torch.as_tensor(x), impl="matmul").numpy()
        assert out.shape == (n,)
        np.testing.assert_allclose(out, oracle.fft_radix2(x), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(out, _jax(jax_fft.fft, x), **TOL)

    @pytest.mark.parametrize("n", (64, 1024, 4096))
    def test_fft_f32_snr(self, rng, n):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
        out = fft.fft(torch.as_tensor(x), impl="matmul").numpy()
        assert out.dtype == np.complex64
        assert _snr_c(oracle.fft_radix2(x.astype(np.complex128)), out) >= 60.0
        assert _snr_c(_jax(jax_fft.fft, x).astype(np.complex128), out) >= 100.0

    @pytest.mark.parametrize("n", (8, 256, 1024))
    def test_ifft_roundtrip(self, rng, n):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        spec = fft.fft(torch.as_tensor(x), impl="matmul")
        out = fft.ifft(spec, impl="matmul").numpy()
        np.testing.assert_allclose(out, x, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(out, _jax(jax_fft.ifft, spec.numpy()), **TOL)

    @pytest.mark.parametrize("n", (4, 64, 1024, 4096))
    def test_rfft_f64(self, rng, n):
        x = rng.standard_normal(n)
        out = fft.rfft(torch.as_tensor(x), impl="matmul").numpy()
        assert out.shape[-1] == n // 2 + 1
        np.testing.assert_allclose(out, oracle.rfft(x), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(out, _jax(jax_fft.rfft, x), **TOL)

    @pytest.mark.parametrize("n", (4, 64, 1024, 4096))
    def test_irfft_f64(self, rng, n):
        x = rng.standard_normal(n)
        spec = fft.rfft(torch.as_tensor(x), impl="matmul")
        out = fft.irfft(spec, n, impl="matmul").numpy()
        np.testing.assert_allclose(out, x, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(out, _jax(jax_fft.irfft, spec.numpy(), n), **TOL)

    def test_batched(self, rng):
        x = rng.standard_normal((3, 5, 256))
        out = fft.rfft(torch.as_tensor(x), impl="matmul").numpy()
        assert out.shape == (3, 5, 129)
        np.testing.assert_allclose(out, np.fft.rfft(x), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(out, _jax(jax_fft.rfft, x), **TOL)

    @pytest.mark.parametrize("n", (64, 1024))
    def test_rfft_f32_snr(self, rng, n):
        x = rng.standard_normal((4, n)).astype(np.float32)
        out = fft.rfft(torch.as_tensor(x), impl="matmul").numpy()
        assert _snr_c(np.fft.rfft(x.astype(np.float64)), out) >= 60.0
        assert _snr_c(_jax(jax_fft.rfft, x).astype(np.complex128), out) >= 100.0


def test_irfft_real_spectrum_input():
    """A real-dtype spectrum (a magnitude spectrum) through irfft keeps its
    complex back-twiddles, and a float64 one stays float64."""
    x = np.random.default_rng(11).standard_normal(64)
    mag = np.abs(oracle.rfft(x))
    ref = np.fft.irfft(mag, 64)
    out32 = fft.irfft(torch.as_tensor(mag, dtype=torch.float32), 64, impl="matmul").numpy()
    np.testing.assert_allclose(out32, ref, atol=1e-5)
    out64 = fft.irfft(torch.as_tensor(mag), 64, impl="matmul").numpy()
    assert out64.dtype == np.float64
    np.testing.assert_allclose(out64, ref, atol=1e-12)
    np.testing.assert_allclose(out64, _jax(jax_fft.irfft, mag, 64), **TOL)


def test_rfft_complex_input_raises():
    with pytest.raises(ValueError, match="real-valued"):
        fft.rfft(torch.ones(16, dtype=torch.complex64), impl="matmul")


@pytest.mark.parametrize("wk", ("hann", "hamming"))
def test_stft_vs_oracle(rng, wk):
    x = rng.standard_normal(8192)
    out = stft.stft(torch.as_tensor(x), 1024, 256, wk, impl="matmul").numpy()
    ref = oracle.stft(x, 1024, 256, wk)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(out, np.asarray(jax_stft.stft(jnp.asarray(x), 1024, 256, wk,
                                                             impl="matmul")), **TOL)


def test_istft_vs_oracle(rng):
    x = rng.standard_normal(8192)
    spec = oracle.stft(x, 1024, 256)
    out = stft.istft(torch.as_tensor(spec), 1024, 256, impl="matmul").numpy()
    ref = oracle.istft(spec, 1024, 256)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(out, np.asarray(jax_stft.istft(jnp.asarray(spec), 1024, 256,
                                                              impl="matmul")), **TOL)

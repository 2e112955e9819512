"""The port's FFT family (ops/fft and kernels/fft_kernel) on the CPU: the
Stockham kernels' plain versions against numpy and against the JAX
package's Pallas kernels in interpret mode, the radix-2 and split-radix
impls against the JAX package's, and the routing of ``impl``.

Tolerances: float32 transforms >= 100 dB against float64 numpy (the JAX
kernels' own bar); float64 transforms to 1e-9 relative (both sides are
exact radix-2 arithmetic in float64, summed in another order)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.kernels import fft_kernel as jax_fk
from audiosignalprocess_tpu.ops import fft as jax_fft
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.ops import fft

SIZES = (2, 4, 8, 64, 256, 1024, 4096)


@pytest.fixture()
def rng():
    return np.random.default_rng(31)


def _planar_snr(ref, re, im):
    return oracle.snr_db(np.concatenate([ref.real, ref.imag], axis=None),
                         np.concatenate([np.asarray(re, np.float64),
                                         np.asarray(im, np.float64)], axis=None))


class TestStockhamLanes:
    """Twin of tests/kernels/test_fft_kernel.py::TestStockhamLanes (the
    radix and rows knobs are TPU tuning and have no twin)."""

    @pytest.mark.parametrize("n", (8, 64, 128, 256, 1024))
    def test_forward_inverse(self, rng, n):
        xr = rng.standard_normal((5, n)).astype(np.float32)
        xi = rng.standard_normal((5, n)).astype(np.float32)
        yr, yi = fk.fft_stockham_lanes(torch.as_tensor(xr), torch.as_tensor(xi), -1.0)
        ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        assert _planar_snr(ref, yr, yi) >= 100.0
        zr, zi = fk.fft_stockham_lanes(yr, yi, +1.0)
        back = (zr.numpy() + 1j * zi.numpy()) / n
        assert oracle.snr_db(np.concatenate([xr, xi]).astype(np.float64),
                             np.concatenate([back.real, back.imag])) >= 100.0

    def test_ragged_batch(self, rng):
        xr = rng.standard_normal((300, 128)).astype(np.float32)
        xi = rng.standard_normal((300, 128)).astype(np.float32)
        yr, yi = fk.fft_stockham_lanes(torch.as_tensor(xr), torch.as_tensor(xi), -1.0)
        assert yr.shape == yi.shape == (300, 128)
        ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        assert _planar_snr(ref, yr, yi) >= 100.0

    @pytest.mark.parametrize("n", (2, 4, 8, 256, 1024))
    @pytest.mark.parametrize("sign", (-1.0, 1.0))
    def test_plain_version_vs_jax_interpret(self, rng, n, sign):
        """The port's plain Stockham stages against the JAX Pallas kernel
        (interpret mode), float64 on both sides."""
        xr, xi = rng.standard_normal((3, n)), rng.standard_normal((3, n))
        jr, ji = jax_fk.fft_stockham_lanes(jnp.asarray(xr), jnp.asarray(xi), sign)
        pr, pi = fk.fft_stockham_lanes(torch.as_tensor(xr), torch.as_tensor(xi), sign)
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-9, atol=1e-9 * n)
        np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=1e-9, atol=1e-9 * n)

    def test_guards(self):
        with pytest.raises(ValueError, match="power-of-two"):
            fk.fft_stockham_lanes(torch.zeros(2, 48), torch.zeros(2, 48), -1.0)
        with pytest.raises(ValueError, match="one shape"):
            fk.fft_stockham_lanes(torch.zeros(2, 64), torch.zeros(3, 64), -1.0)


class TestRfftStockham:
    """Twin of tests/kernels/test_fft_kernel.py::TestRfftStockham."""

    @pytest.mark.parametrize("n", (4, 256, 1024, 4096))
    def test_rfft_vs_numpy(self, rng, n):
        for b in (1, 5, 130):
            x = rng.standard_normal((b, n)).astype(np.float32)
            sr, si = fk.rfft_stockham(torch.as_tensor(x))
            assert sr.shape == si.shape == (b, n // 2 + 1)
            assert _planar_snr(np.fft.rfft(x.astype(np.float64)), sr, si) >= 100.0

    @pytest.mark.parametrize("n", (8, 1024))
    def test_irfft_roundtrip(self, rng, n):
        x = rng.standard_normal((9, n)).astype(np.float32)
        sr, si = fk.rfft_stockham(torch.as_tensor(x))
        back = fk.irfft_stockham(sr, si, n)
        assert oracle.snr_db(x.astype(np.float64), back) >= 100.0

    def test_ops_api_routing(self, rng):
        """impl="stockham" on the ops API takes the fused real kernels' route
        (their plain versions on the CPU) and matches the oracle convention,
        batched over any leading shape, without a launch."""
        before = (fk.rfft_stockham.launches, fk.irfft_stockham.launches)
        x = rng.standard_normal((2, 3, 1024)).astype(np.float32)
        s = fft.rfft(torch.as_tensor(x), impl="stockham")
        assert s.shape == (2, 3, 513) and s.dtype == torch.complex64
        assert _planar_snr(np.fft.rfft(x.astype(np.float64)), s.real, s.imag) >= 100.0
        y = fft.irfft(s, 1024, impl="stockham")
        assert oracle.snr_db(x.astype(np.float64), y) >= 100.0
        assert (fk.rfft_stockham.launches, fk.irfft_stockham.launches) == before

    def test_guards(self):
        with pytest.raises(ValueError):
            fk.rfft_stockham(torch.zeros(2, 48))  # not 2^k
        with pytest.raises(ValueError):
            fk.irfft_stockham(torch.zeros(2, 5), torch.zeros(2, 5), 16)
        with pytest.raises(ValueError):
            fk.rfft_stockham(torch.zeros(2, 2))  # the kernel needs n >= 4

    @pytest.mark.parametrize("n", (4, 8, 256, 1024))
    def test_plain_versions_vs_jax_interpret(self, rng, n):
        """rfft_stockham and irfft_stockham's plain versions against the JAX
        Pallas kernels (interpret mode), float64, on a real signal's
        spectrum."""
        x = rng.standard_normal((3, n))
        jr, ji = jax_fk.rfft_stockham(jnp.asarray(x))
        pr, pi = fk.rfft_stockham(torch.as_tensor(x))
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-9, atol=1e-9 * n)
        np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=1e-9, atol=1e-9 * n)
        jy = jax_fk.irfft_stockham(jr, ji, n)
        py = fk.irfft_stockham(pr, pi, n)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-9, atol=1e-12)

    @pytest.mark.parametrize("n", (4, 64, 1024))
    def test_irfft_edge_bins_follow_torch(self, rng, n):
        """A spectrum whose bins 0 and n/2 carry imaginary parts: the
        kernel's plain version and every impl of ops.fft.irfft drop them,
        as torch.fft.irfft and numpy.fft.irfft do.  (The JAX package's
        pack route keeps them, so this case alone differs from it: ROADMAP
        Queue 3.)"""
        spec = rng.standard_normal((3, n // 2 + 1)) + 1j * rng.standard_normal((3, n // 2 + 1))
        ref = np.fft.irfft(spec, n)
        st = torch.as_tensor(spec)
        np.testing.assert_allclose(torch.fft.irfft(st, n).numpy(), ref, atol=1e-13)
        y = fk.irfft_stockham(st.real.contiguous(), st.imag.contiguous(), n)
        np.testing.assert_allclose(y.numpy(), ref, atol=1e-13)
        for impl in ("radix2", "splitradix", "stockham", "stockham_split"):
            np.testing.assert_allclose(fft.irfft(st, n, impl=impl).numpy(), ref, atol=1e-13)


class TestImpls:
    """Twins of tests/unit/test_fft.py's radix2/splitradix cases, against
    the oracle and against the JAX package's same impl (float64)."""

    @pytest.mark.parametrize("impl", ("radix2", "splitradix", "stockham", "stockham_split"))
    @pytest.mark.parametrize("n", SIZES)
    def test_fft_f64(self, rng, impl, n):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        out = fft.fft(torch.as_tensor(x), impl=impl).numpy()
        np.testing.assert_allclose(out, oracle.fft_radix2(x), rtol=1e-8, atol=1e-8)
        if impl in ("radix2", "splitradix"):
            np.testing.assert_allclose(out, np.asarray(jax_fft.fft(x, impl=impl)),
                                       rtol=1e-12, atol=1e-12 * n)

    @pytest.mark.parametrize("impl", ("radix2", "splitradix", "stockham"))
    @pytest.mark.parametrize("n", (64, 1024, 4096))
    def test_fft_f32_snr(self, rng, impl, n):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
        out = fft.fft(torch.as_tensor(x), impl=impl)
        assert out.dtype == torch.complex64
        ref = oracle.fft_radix2(x.astype(np.complex128))
        assert _planar_snr(ref, out.real, out.imag) >= 100.0

    @pytest.mark.parametrize("impl", ("radix2", "splitradix", "stockham"))
    @pytest.mark.parametrize("n", (8, 256, 1024))
    def test_ifft_roundtrip(self, rng, impl, n):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        out = fft.ifft(fft.fft(torch.as_tensor(x), impl=impl), impl=impl)
        np.testing.assert_allclose(out.numpy(), x, rtol=1e-8, atol=1e-8)

    @pytest.mark.parametrize("impl", ("radix2", "splitradix", "stockham", "stockham_split"))
    @pytest.mark.parametrize("n", (4, 64, 1024, 4096))
    def test_rfft_irfft_f64(self, rng, impl, n):
        x = rng.standard_normal((2, n))
        s = fft.rfft(torch.as_tensor(x), impl=impl)
        assert s.shape[-1] == n // 2 + 1
        np.testing.assert_allclose(s.numpy(), np.fft.rfft(x), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(fft.irfft(s, n, impl=impl).numpy(), x,
                                   rtol=1e-8, atol=1e-8)
        if impl in ("radix2", "splitradix"):
            jax_s = np.asarray(jax_fft.rfft(x, impl=impl))
            np.testing.assert_allclose(s.numpy(), jax_s, rtol=1e-12, atol=1e-12 * n)
            np.testing.assert_allclose(
                fft.irfft(s, n, impl=impl).numpy(),
                np.asarray(jax_fft.irfft(jnp.asarray(jax_s), n, impl=impl)),
                rtol=1e-12, atol=1e-13)

    def test_batched(self, rng):
        x = rng.standard_normal((3, 5, 256))
        for impl in ("radix2", "splitradix", "stockham"):
            out = fft.rfft(torch.as_tensor(x), impl=impl)
            np.testing.assert_allclose(out.numpy(), np.fft.rfft(x), rtol=1e-8, atol=1e-8)

    def test_irfft_real_spectrum_input(self, rng):
        """A real-dtype (magnitude) spectrum keeps its back-twiddles complex."""
        mag = np.abs(np.fft.rfft(rng.standard_normal(64)))
        ref = np.fft.irfft(mag, 64)
        for impl in ("radix2", "splitradix", "stockham"):
            out = fft.irfft(torch.as_tensor(mag, dtype=torch.float32), 64, impl=impl)
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
            out64 = fft.irfft(torch.as_tensor(mag), 64, impl=impl)
            assert out64.dtype == torch.float64
            np.testing.assert_allclose(out64.numpy(), ref, atol=1e-12)

    def test_rfft_complex_input_raises(self):
        for impl in ("radix2", "splitradix", "stockham", "torch", "auto"):
            with pytest.raises(ValueError, match="real-valued"):
                fft.rfft(torch.ones(16, dtype=torch.complex64), impl=impl)

    def test_hilbert_envelope_impls_agree(self, rng):
        from audiosignalprocess_tpu.effects.envelope import hilbert_envelope as jax_hilbert
        from audiosignalprocess_tpu_torch.effects.envelope import hilbert_envelope

        x = rng.standard_normal((2, 512))
        ref = np.asarray(jax_hilbert(jnp.asarray(x), impl="xla"))
        for impl in ("torch", "radix2", "stockham"):
            np.testing.assert_allclose(hilbert_envelope(torch.as_tensor(x), impl=impl).numpy(),
                                       ref, rtol=1e-9, atol=1e-10)


class TestRouting:
    def test_auto_resolution(self):
        """auto: a CUDA float32/complex64 tensor takes the kernels, anything
        else torch.fft (a stand-in tensor: the resolver reads only is_cuda
        and dtype)."""
        on_card = lambda dt: SimpleNamespace(is_cuda=True, dtype=dt)
        assert fft._resolve_impl("auto", on_card(torch.float32)) == "stockham"
        assert fft._resolve_impl("auto", on_card(torch.complex64)) == "stockham"
        assert fft._resolve_impl("auto", on_card(torch.float64)) == "torch"
        assert fft._resolve_impl("auto", on_card(torch.complex128)) == "torch"
        assert fft._resolve_impl("auto", torch.zeros(4)) == "torch"
        assert fft._resolve_impl("radix2", on_card(torch.float32)) == "radix2"
        assert fft.DEFAULT_IMPL == "auto"

    def test_jax_names(self):
        x = torch.zeros(4)
        assert [fft._resolve_impl(n, x) for n in ("xla", "pallas_sk", "pallas_sk_split")] == [
            "torch", "stockham", "stockham_split"]
        assert fft._resolve_impl("matmul", x) == "matmul"
        assert [fft._resolve_impl(n, x) for n in (
            "pallas", "pallas_r2", "pallas_r2_stages", "pallas_cg")] == [
            "fourstep", "radix2_lanes", "radix2_stages", "pease"]
        for name in ("pallas", "pallas_r2", "pallas_r2_stages", "pallas_cg"):
            z = fft.fft(torch.ones(8, dtype=torch.complex64), impl=name)
            np.testing.assert_allclose(z.numpy(), np.fft.fft(np.ones(8)), atol=1e-6)
        with pytest.raises(ValueError, match="unknown FFT impl"):
            fft.fft(torch.zeros(8, dtype=torch.complex64), impl="bogus")

    def test_fft_complex_direct_dft_below_4(self, rng):
        before = fk.fft_stockham_lanes.launches
        for n in (1, 2):
            x = torch.as_tensor(rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)))
            np.testing.assert_allclose(fk.fft_complex(x, -1.0).numpy(),
                                       np.fft.fft(x.numpy()), atol=1e-14)
        assert fk.fft_stockham_lanes.launches == before

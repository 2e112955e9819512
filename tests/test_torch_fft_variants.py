"""The FFT variant impls of the port (``fourstep``, ``radix2_lanes``,
``radix2_stages``, ``pease``; the JAX package's ``pallas``, ``pallas_r2``,
``pallas_r2_stages`` and ``pallas_cg``) on the CPU, where each kernel
wrapper runs its plain version.

- Twins of tests/kernels/test_fft_kernel.py's ``TestPlanarCores``,
  ``TestImplRegistry``, ``TestRadix2Lanes`` and ``TestPeaseLanes``, each
  at the JAX test's own bar.
- Each plain version against the JAX kernel in interpret mode on the same
  numpy inputs: >= 100 dB in float32 (the JAX radix-2 lanes and Pease
  kernels compute their twiddles with f32 cos/sin, so the two are not
  bit-equal) and rtol 1e-9 in float64.
- The slice, ``FIRStage -> GateStage`` with each impl, at 2 x 16384
  against the JAX chain with the JAX impl name: rtol 1e-9 in float64,
  >= 60 dB in float32 (the gate's hard thresholds may flip a borderline
  bin under float32 rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu import pipeline as jax_pipeline
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.kernels import fft_kernel as jax_fk
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.ops import fft
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.pipeline import Chain, FIRStage, GateStage

CORES = (fk.fft_fourstep, fk.fft_radix2_stages)
KERNELS = {  # port wrapper: (JAX kernel, JAX impl name, port impl name, least n)
    fk.fft_fourstep: (jax_fk.fft_fourstep, "pallas", "fourstep", 4),
    fk.fft_radix2_lanes: (jax_fk.fft_radix2_lanes, "pallas_r2", "radix2_lanes", 2),
    fk.fft_radix2_stages: (jax_fk.fft_radix2_stages, "pallas_r2_stages", "radix2_stages", 2),
    fk.fft_pease_lanes: (jax_fk.fft_pease_lanes, "pallas_cg", "pease", 2),
}


@pytest.fixture()
def rng():
    return np.random.default_rng(23)


def _t(a):
    return torch.as_tensor(a)


def _planar_snr(ref, re, im):
    return oracle.snr_db(np.concatenate([ref.real, ref.imag], axis=None),
                         np.concatenate([np.asarray(re, np.float64),
                                         np.asarray(im, np.float64)], axis=None))


class TestPlanarCores:
    """Twin of tests/kernels/test_fft_kernel.py::TestPlanarCores."""

    @pytest.mark.parametrize("core", CORES, ids=("fourstep", "radix2"))
    @pytest.mark.parametrize("n", (4, 64, 512, 1024, 4096))
    def test_forward_f32(self, rng, core, n):
        b = 24
        xr = rng.standard_normal((b, n)).astype(np.float32)
        xi = rng.standard_normal((b, n)).astype(np.float32)
        ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        yr, yi = core(_t(xr), _t(xi), -1.0)
        assert yr.dtype == torch.float32
        got = yr.numpy() + 1j * yi.numpy()
        assert oracle.snr_db(np.abs(ref), np.abs(got)) >= 60.0
        err = np.abs(ref - got)
        assert 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(err**2)) >= 60.0

    @pytest.mark.parametrize("core", CORES, ids=("fourstep", "radix2"))
    def test_inverse_roundtrip(self, rng, core):
        n, b = 1024, 8
        xr = rng.standard_normal((b, n)).astype(np.float32)
        xi = rng.standard_normal((b, n)).astype(np.float32)
        yr, yi = core(_t(xr), _t(xi), -1.0)
        zr, zi = core(yr, yi, 1.0)
        np.testing.assert_allclose(zr.numpy() / n, xr, atol=2e-3)
        np.testing.assert_allclose(zi.numpy() / n, xi, atol=2e-3)

    @pytest.mark.parametrize("core", CORES, ids=("fourstep", "radix2"))
    def test_f64(self, rng, core):
        n, b = 256, 8
        xr = rng.standard_normal((b, n))
        xi = rng.standard_normal((b, n))
        yr, yi = core(_t(xr), _t(xi), -1.0)
        np.testing.assert_allclose(yr.numpy() + 1j * yi.numpy(), np.fft.fft(xr + 1j * xi),
                                   rtol=1e-9, atol=1e-9)

    def test_batch_padding(self, rng):
        """Any batch: the kernel takes ragged row counts (no padding)."""
        n = 256
        for b in (1, 3, 9, 100):
            xr = rng.standard_normal((b, n)).astype(np.float32)
            yr, yi = fk.fft_fourstep(_t(xr), torch.zeros(b, n), -1.0)
            assert yr.shape == (b, n)
            ref = np.fft.fft(xr.astype(np.float64))
            got = yr.numpy() + 1j * yi.numpy()
            assert oracle.snr_db(np.abs(ref) + 1e-30, np.abs(got) + 1e-30) >= 60.0


class TestImplRegistry:
    """Twin of tests/kernels/test_fft_kernel.py::TestImplRegistry: the kernel
    impls plug into the ops.fft API under their JAX names."""

    @pytest.mark.parametrize("impl", ("pallas", "pallas_r2"))
    @pytest.mark.parametrize("n", (64, 1024))
    def test_fft_api(self, rng, impl, n):
        x = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))).astype(np.complex64)
        ref = np.fft.fft(x.astype(np.complex128))
        out = fft.fft(_t(x), impl=impl).numpy()
        err = np.abs(ref - out)
        assert 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(err**2)) >= 60.0

    @pytest.mark.parametrize("impl", ("pallas", "pallas_r2"))
    def test_rfft_irfft_api(self, rng, impl):
        x = rng.standard_normal((4, 1024)).astype(np.float32)
        ref = np.fft.rfft(x.astype(np.float64))
        out = fft.rfft(_t(x), impl=impl)
        err = np.abs(ref - out.numpy())
        assert 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(err**2)) >= 60.0
        back = fft.irfft(out, 1024, impl=impl).numpy()
        assert oracle.snr_db(x.astype(np.float64), back) >= 60.0

    def test_overlap_save_with_pallas(self, rng):
        x = rng.standard_normal(8192).astype(np.float32)
        h = oracle.design_fir(64, 0.25)
        ref = oracle.fir_direct(x.astype(np.float64), h)
        out = overlap_save(_t(x), h, 1024, impl="pallas").numpy()
        assert oracle.snr_db(ref, out) >= 60.0

    @pytest.mark.parametrize("core", list(KERNELS), ids=lambda k: k.__name__)
    def test_every_impl_name_resolves(self, rng, core):
        """The port name and the JAX name of each kernel impl: the same
        transforms, forward, inverse and real, against numpy (float64)."""
        _, jax_name, name, _ = KERNELS[core]
        assert fft._resolve_impl(jax_name, torch.zeros(4)) == name
        x = rng.standard_normal((3, 256)) + 1j * rng.standard_normal((3, 256))
        for impl in (name, jax_name):
            np.testing.assert_allclose(fft.fft(_t(x), impl=impl).numpy(), np.fft.fft(x),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(fft.ifft(_t(x), impl=impl).numpy(), np.fft.ifft(x),
                                       rtol=1e-9, atol=1e-12)
            s = fft.rfft(_t(x.real), impl=impl)
            np.testing.assert_allclose(s.numpy(), np.fft.rfft(x.real), rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(fft.irfft(s, 256, impl=impl).numpy(), x.real,
                                       rtol=1e-9, atol=1e-12)


class TestRadix2Lanes:
    """Twin of tests/kernels/test_fft_kernel.py::TestRadix2Lanes."""

    @pytest.mark.parametrize("n", (8, 256, 1024, 4096))
    def test_forward_inverse(self, rng, n):
        xr = rng.standard_normal((5, n)).astype(np.float32)
        xi = rng.standard_normal((5, n)).astype(np.float32)
        yr, yi = fk.fft_radix2_lanes(_t(xr), _t(xi), -1.0)
        ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        assert _planar_snr(ref, yr, yi) >= 100.0
        zr, zi = fk.fft_radix2_lanes(yr, yi, +1.0)
        back = (zr.numpy() + 1j * zi.numpy()) / n
        assert oracle.snr_db(np.concatenate([xr, xi]).astype(np.float64),
                             np.concatenate([back.real, back.imag])) >= 100.0

    def test_impl_registry(self, rng):
        x = rng.standard_normal((3, 512)) + 1j * rng.standard_normal((3, 512))
        got = fft.fft(_t(x.astype(np.complex64)), impl="pallas_r2").numpy()
        assert _planar_snr(np.fft.fft(x), got.real, got.imag) >= 100.0


class TestPeaseLanes:
    """Twin of tests/kernels/test_fft_kernel.py::TestPeaseLanes."""

    @pytest.mark.parametrize("n", (8, 256, 1024, 4096))
    def test_forward_inverse(self, rng, n):
        xr = rng.standard_normal((5, n)).astype(np.float32)
        xi = rng.standard_normal((5, n)).astype(np.float32)
        yr, yi = fk.fft_pease_lanes(_t(xr), _t(xi), -1.0)
        ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        assert _planar_snr(ref, yr, yi) >= 100.0
        zr, zi = fk.fft_pease_lanes(yr, yi, +1.0)
        back = (zr.numpy() + 1j * zi.numpy()) / n
        assert oracle.snr_db(np.concatenate([xr, xi]).astype(np.float64),
                             np.concatenate([back.real, back.imag])) >= 100.0

    def test_matches_stockham_exactly_in_structure(self, rng):
        n = 512
        xr = _t(rng.standard_normal((3, n)).astype(np.float32))
        xi = _t(rng.standard_normal((3, n)).astype(np.float32))
        pr, pi = fk.fft_pease_lanes(xr, xi, -1.0)
        sr, si = fk.fft_stockham_lanes(xr, xi, -1.0)
        assert oracle.snr_db(torch.cat([sr, si]).double().numpy(),
                             torch.cat([pr, pi]).double().numpy()) >= 110.0

    def test_impl_registry(self, rng):
        x = rng.standard_normal((3, 512)) + 1j * rng.standard_normal((3, 512))
        got = fft.fft(_t(x.astype(np.complex64)), impl="pallas_cg").numpy()
        assert _planar_snr(np.fft.fft(x), got.real, got.imag) >= 100.0

    def test_size_guard(self):
        """The JAX kernel's n <= 2^24 bound, kept for parity of contract."""
        big = torch.zeros(1, 1 << 25)
        with pytest.raises(ValueError, match="2\\^24"):
            fk.fft_pease_lanes(big, big, -1.0)


class TestPlainVersionsVsJax:
    """Each plain version against its JAX Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("core", list(KERNELS), ids=lambda k: k.__name__)
    @pytest.mark.parametrize("n", ("least", 8, 256, 1024))
    @pytest.mark.parametrize("sign", (-1.0, 1.0))
    def test_float64(self, rng, core, n, sign):
        jax_core, _, _, least = KERNELS[core]
        n = least if n == "least" else n
        xr, xi = rng.standard_normal((3, n)), rng.standard_normal((3, n))
        jr, ji = jax_core(jnp.asarray(xr), jnp.asarray(xi), sign)
        pr, pi = core(_t(xr), _t(xi), sign)
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-9, atol=1e-9 * n)
        np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=1e-9, atol=1e-9 * n)

    @pytest.mark.parametrize("core", list(KERNELS), ids=lambda k: k.__name__)
    @pytest.mark.parametrize("n", (8, 512))
    def test_float32(self, rng, core, n):
        jax_core = KERNELS[core][0]
        xr = rng.standard_normal((5, n)).astype(np.float32)
        xi = rng.standard_normal((5, n)).astype(np.float32)
        for sign in (-1.0, 1.0):
            jr, ji = jax_core(jnp.asarray(xr), jnp.asarray(xi), sign)
            pr, pi = core(_t(xr), _t(xi), sign)
            assert pr.dtype == torch.float32
            ref = np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
            assert _planar_snr(ref, pr, pi) >= 100.0


def _tone_burst(rng, c, n, fs=48000):
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    return x + np.where((t > 0.25 * n / fs) & (t < 0.7 * n / fs),
                        np.sin(2 * np.pi * 440.0 * t), 0.0)


@pytest.mark.parametrize("core", list(KERNELS), ids=lambda k: k.__name__)
@pytest.mark.parametrize("dtype", ("float64", "float32"))
def test_slice_chain_vs_jax(core, dtype):
    """The slice: Chain([FIRStage(nfft=1024), GateStage(1024/256, 8 noise
    frames)]).full_flush with each kernel impl, against the JAX chain with
    the JAX impl name on the same input."""
    _, jax_name, name, _ = KERNELS[core]
    x = _tone_burst(np.random.default_rng(71), 2, 16384).astype(dtype)
    h = design_fir(64, 0.3)
    port = Chain([FIRStage(h=h, nfft=1024, impl=name),
                  GateStage(nfft=1024, hop=256, noise_frames=8, impl=name)])
    jax = jax_pipeline.Chain([jax_pipeline.FIRStage(h=h, nfft=1024, impl=jax_name),
                              jax_pipeline.GateStage(nfft=1024, hop=256, noise_frames=8,
                                                     impl=jax_name)])
    got = port.full_flush(_t(x)).numpy()
    ref = np.asarray(jax.full_flush(jnp.asarray(x)))
    assert got.shape == ref.shape == x.shape and got.dtype == x.dtype
    if dtype == "float64":
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    else:
        assert oracle.snr_db(ref.astype(np.float64), got.astype(np.float64)) >= 60.0

"""fft_stockham_manual, the ASP_SK_PIPE switch and the roofline, debug and
profiling utils of the port on the CPU, where every kernel wrapper runs
its plain version.

- The plain version against the JAX ``fft_stockham_manual`` in interpret
  mode (the JAX package's own ``test_manual_pipeline_parity`` cases:
  batches 100 and 300 at n = 256, fewer tiles than ring slots and a
  partial last tile), both signs: rtol 1e-9 in float64, >= 100 dB in
  float32, and >= 100 dB against numpy's float64 FFT.
- ``ASP_SK_PIPE``: a twin of ``test_pipe_validation``; under ``manual``
  every Stockham caller on the CPU answers as without it and counts no
  launch; the ring's shared-memory limit raises on every device.
- The slice, ``FIRStage -> GateStage`` with ``impl="stockham_split"``
  under the pipe, at 2 x 16384 against the JAX chain with
  ``pallas_sk_split``: rtol 1e-9 in float64, >= 60 dB in float32 (the
  gate's hard thresholds may flip a borderline bin under float32
  rounding).
- Twins of tests/unit/test_utils.py's ``TestMetrics``,
  ``TestDebug.test_assert_snr`` and ``TestProfiling`` for the port's
  ``utils.metrics``, ``utils.debug`` and ``utils.profiling``.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu import pipeline as jax_pipeline
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.kernels import fft_kernel as jax_fk
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels._build import SMEM_LIMIT
from audiosignalprocess_tpu_torch.ops import fft
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.ops.stft import istft, stft
from audiosignalprocess_tpu_torch.pipeline import Chain, FIRStage, GateStage
from audiosignalprocess_tpu_torch.utils import debug, metrics, profiling


@pytest.fixture()
def rng():
    return np.random.default_rng(81)


def _t(a):
    return torch.as_tensor(a)


def _planar_snr(ref, re, im):
    return oracle.snr_db(np.concatenate([ref.real, ref.imag], axis=None),
                         np.concatenate([np.asarray(re, np.float64),
                                         np.asarray(im, np.float64)], axis=None))


class TestManualVsJax:
    """The plain version against the JAX kernel in interpret mode, on the
    cases of tests/kernels/test_fft_kernel.py::test_manual_pipeline_parity."""

    @pytest.mark.parametrize("batch", (100, 300))
    @pytest.mark.parametrize("sign", (-1.0, 1.0))
    def test_float64(self, rng, batch, sign):
        xr, xi = rng.standard_normal((batch, 256)), rng.standard_normal((batch, 256))
        jr, ji = jax_fk.fft_stockham_manual(jnp.asarray(xr), jnp.asarray(xi), sign)
        pr, pi = fk.fft_stockham_manual(_t(xr), _t(xi), sign)
        assert pr.dtype == torch.float64 and pr.shape == (batch, 256)
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-9, atol=1e-9 * 256)
        np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=1e-9, atol=1e-9 * 256)

    @pytest.mark.parametrize("batch", (100, 300))
    @pytest.mark.parametrize("sign", (-1.0, 1.0))
    def test_float32(self, rng, batch, sign):
        xr = rng.standard_normal((batch, 256)).astype(np.float32)
        xi = rng.standard_normal((batch, 256)).astype(np.float32)
        jr, ji = jax_fk.fft_stockham_manual(jnp.asarray(xr), jnp.asarray(xi), sign)
        pr, pi = fk.fft_stockham_manual(_t(xr), _t(xi), sign)
        assert pr.dtype == torch.float32 and pr.shape == (batch, 256)
        jax_out = np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
        assert _planar_snr(jax_out, pr, pi) >= 100.0
        z = xr.astype(np.float64) + 1j * xi.astype(np.float64)
        ref = np.fft.fft(z) if sign < 0 else np.fft.ifft(z) * 256
        assert _planar_snr(ref, pr, pi) >= 100.0

    def test_plain_version_is_the_stockham_stages(self):
        assert fk.fft_stockham_manual_ref is fk.fft_stockham_lanes_ref


class TestPipe:
    def test_pipe_validation(self, monkeypatch):
        """Twin of tests/kernels/test_fft_kernel.py::test_pipe_validation."""
        monkeypatch.setenv("ASP_SK_PIPE", "bogus")
        with pytest.raises(ValueError, match="ASP_SK_PIPE"):
            fk._sk_pipe()
        with pytest.raises(ValueError, match="ASP_SK_PIPE"):
            fk.fft_stockham_lanes(torch.zeros(2, 64), torch.zeros(2, 64), -1.0)

    @pytest.mark.parametrize("pipe", ("auto", "manual"))
    def test_pipe_values(self, monkeypatch, pipe):
        monkeypatch.setenv("ASP_SK_PIPE", pipe)
        assert fk._sk_pipe() == pipe
        monkeypatch.delenv("ASP_SK_PIPE")
        assert fk._sk_pipe() == "auto"

    @pytest.mark.parametrize("impl", ("stockham", "stockham_split", "pallas_sk",
                                      "pallas_sk_split"))
    @pytest.mark.parametrize("dtype", (np.float32, np.float64))
    def test_cpu_answers_the_same_under_the_pipe(self, monkeypatch, rng, impl, dtype):
        """On the CPU the wrappers run their plain versions either way:
        ops.fft's transforms answer bit for bit as without the pipe, and
        no wrapper counts a launch."""
        x = _t(rng.standard_normal((3, 512)).astype(dtype))
        z = torch.complex(x, x.flip(-1))
        spec = torch.fft.rfft(x)
        calls = (lambda: fft.fft(z, impl=impl), lambda: fft.ifft(z, impl=impl),
                 lambda: fft.rfft(x, impl=impl), lambda: fft.irfft(spec, 512, impl=impl),
                 lambda: stft(x, 128, 32, impl=impl),
                 lambda: istft(stft(x, 128, 32, impl="torch"), 128, 32, impl=impl))
        monkeypatch.delenv("ASP_SK_PIPE", raising=False)
        plain = [call() for call in calls]
        counters = (fk.fft_stockham_lanes, fk.fft_stockham_manual, fk.rfft_stockham,
                    fk.irfft_stockham)
        before = [k.launches for k in counters]
        monkeypatch.setenv("ASP_SK_PIPE", "manual")
        for call, want in zip(calls, plain):
            got = call()
            assert got.dtype == want.dtype
            assert torch.equal(got, want)
        assert [k.launches for k in counters] == before

    def test_manual_wrapper_on_the_cpu_counts_no_launch(self, rng):
        xr, xi = _t(rng.standard_normal((5, 64))), _t(rng.standard_normal((5, 64)))
        before = fk.fft_stockham_manual.launches
        yr, yi = fk.fft_stockham_manual(xr, xi, -1.0)
        assert fk.fft_stockham_manual.launches == before
        assert _planar_snr(np.fft.fft(xr.numpy() + 1j * xi.numpy()), yr, yi) >= 200.0

    def test_guards(self):
        with pytest.raises(ValueError, match="power-of-two"):
            fk.fft_stockham_manual(torch.zeros(2, 96), torch.zeros(2, 96), -1.0)
        with pytest.raises(ValueError, match="planar"):
            fk.fft_stockham_manual(torch.zeros(2, 64), torch.zeros(3, 64), -1.0)


class TestRing:
    @pytest.mark.parametrize("n,rows,nbuf", ((2, 512, 3), (8, 128, 3), (512, 2, 3),
                                             (1024, 1, 3), (4096, 1, 3), (8192, 1, 2)))
    def test_ring_geometry(self, n, rows, nbuf):
        """A tile is max(1, 1024 / n) rows; the ring is 3 slots deep while
        it fits in shared memory with the work tile and a barrier per slot,
        2 at n = 8192 (the twiddles stay in device memory)."""
        got_rows, got_nbuf, smem = fk.manual_ring(n)
        assert (got_rows, got_nbuf) == (rows, nbuf)
        assert smem == (nbuf + 1) * 8 * rows * n + 8 * nbuf
        assert smem <= SMEM_LIMIT

    @pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
    def test_ring_limit_raises_on_every_device(self, dtype):
        """n = 16384: not even a 2-slot ring of one row fits; the wrapper
        raises, naming the limit, before it would dispatch (here, before
        the plain version)."""
        z = torch.zeros((2, 16384), dtype=dtype)
        with pytest.raises(ValueError, match="SMEM_LIMIT"):
            fk.fft_stockham_manual(z, z, -1.0)
        with pytest.raises(ValueError, match="SMEM_LIMIT"):
            fk.manual_ring(16384)

    def test_pipe_reaches_the_ring_limit_only_on_the_card(self, monkeypatch):
        """Under the pipe, fft_stockham_lanes on a CPU tensor runs its
        plain version at any n (the ring limit binds the kernel only)."""
        monkeypatch.setenv("ASP_SK_PIPE", "manual")
        z = torch.zeros((1, 16384), dtype=torch.float64)
        yr, yi = fk.fft_stockham_lanes(z, z, -1.0)
        assert yr.shape == (1, 16384) and not bool(yr.any())


def _tone_burst(rng, c, n, fs=48000):
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    return x + np.where((t > 0.25 * n / fs) & (t < 0.7 * n / fs),
                        np.sin(2 * np.pi * 440.0 * t), 0.0)


@pytest.mark.parametrize("dtype", ("float64", "float32"))
def test_slice_chain_under_the_pipe_vs_jax(monkeypatch, dtype):
    """The slice: Chain([FIRStage(nfft=1024), GateStage(1024/256, 8 noise
    frames)]).full_flush with impl="stockham_split" under
    ASP_SK_PIPE=manual, against the JAX chain with pallas_sk_split (the
    JAX interpret mode runs its grid form under the pipe)."""
    monkeypatch.setenv("ASP_SK_PIPE", "manual")
    x = _tone_burst(np.random.default_rng(72), 2, 16384).astype(dtype)
    h = design_fir(64, 0.3)
    port = Chain([FIRStage(h=h, nfft=1024, impl="stockham_split"),
                  GateStage(nfft=1024, hop=256, noise_frames=8, impl="stockham_split")])
    jax = jax_pipeline.Chain([
        jax_pipeline.FIRStage(h=h, nfft=1024, impl="pallas_sk_split"),
        jax_pipeline.GateStage(nfft=1024, hop=256, noise_frames=8, impl="pallas_sk_split")])
    got = port.full_flush(_t(x)).numpy()
    ref = np.asarray(jax.full_flush(jnp.asarray(x)))
    assert got.shape == ref.shape == x.shape and got.dtype == x.dtype
    if dtype == "float64":
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    else:
        assert oracle.snr_db(ref.astype(np.float64), got.astype(np.float64)) >= 60.0


class TestMetrics:
    """Twin of tests/unit/test_utils.py::TestMetrics, with the card's figures."""

    def test_snr_db(self):
        x = np.ones(100)
        assert metrics.snr_db(x, x) == np.inf
        noisy = x + 1e-3
        assert 55 < metrics.snr_db(x, noisy) < 65

    def test_roofline_model(self):
        chip = metrics.H100_SXM
        b = metrics.fft_roofline_bytes(64, 1024, 4, complex_io=True)
        assert b == 2 * 64 * 1024 * 8
        assert metrics.fft_roofline_bytes(64, 1024, 4) == 2 * 64 * 1024 * 4
        assert metrics.roofline_time_s(b, chip) == b / (chip.hbm_gbps * 1e9)

    def test_h100_figures(self):
        """The published peaks chip_smoke reads its bounds against: 3.35
        TB/s and 67 TFLOP/s float32; 4096 x 1024 complex points move
        67 MB, 0.0200 ms at that rate."""
        chip = metrics.H100_SXM
        assert (chip.hbm_gbps, chip.f32_tflops, chip.bf16_tflops) == (3350.0, 67.0, 989.0)
        t = metrics.roofline_time_s(metrics.fft_roofline_bytes(4096, 1024, 4, True), chip)
        assert round(t * 1e3, 4) == 0.0200
        t = metrics.roofline_time_s(metrics.fft_roofline_bytes(32768, 4096, 4, True), chip)
        assert round(t * 1e3, 3) == 0.641

    @pytest.mark.parametrize("name", ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                                      "some other card"))
    def test_detect_chip(self, monkeypatch, name):
        """The H100 SXM is the one model, the default for any card name."""
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
        assert metrics.detect_chip() is metrics.H100_SXM

    def test_detect_chip_reads_the_card_name(self, monkeypatch):
        asked = []
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: asked.append(a) or "x")
        assert metrics.detect_chip().hbm_gbps > 0
        assert asked == [(0,)]


class TestDebug:
    """Twin of tests/unit/test_utils.py::TestDebug::test_assert_snr."""

    def test_assert_snr(self):
        x = np.random.default_rng(0).standard_normal(256)
        assert debug.assert_snr(x, x + 1e-9) > 60
        with pytest.raises(AssertionError):
            debug.assert_snr(x, x + 0.5, min_db=60)

    def test_assert_snr_takes_tensors(self):
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(256))
        assert debug.assert_snr(x, x.float(), min_db=100.0) >= 100.0
        with pytest.raises(AssertionError, match="gate: SNR"):
            debug.assert_snr(x, torch.zeros_like(x), what="gate")


class TestProfiling:
    """Twin of tests/unit/test_utils.py::TestProfiling."""

    def test_block_logger(self):
        buf = io.StringIO()
        bl = profiling.BlockLogger(stream=buf, every=1)
        for _ in range(3):
            bl.tick(1024, stage="fir")
        lines = [line for line in buf.getvalue().splitlines() if line]
        assert len(lines) == 2  # first tick only sets the clock
        rec = json.loads(lines[0])
        assert rec["samples"] == 1024 and rec["stage"] == "fir"

    def test_span(self):
        with profiling.span("test"):
            assert float(torch.sum(torch.ones(4))) == 4.0

    def test_trace_into_a_directory(self, tmp_path):
        """trace() writes a Chrome trace holding the span."""
        with profiling.trace(str(tmp_path / "prof")):
            with profiling.span("asp_block"):
                torch.fft.rfft(torch.ones(8, 64))
        doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
        assert any(ev.get("name") == "asp_block" for ev in doc["traceEvents"])

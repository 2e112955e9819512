"""The port's phase vocoder (effects/phase_vocoder and the api one-shots)
vs the JAX package's and the float64 oracle.

Twins of the TestPhaseVocoder cases of tests/unit/test_effects.py and of
tests/unit/test_api.py's vocoder one-shots.  Inputs are numpy arrays from
a seeded generator, handed to both packages.

Tolerances: the rotor algebra (unit_rotor, cumrotor, stretch_spec) float64
rtol 1e-10, atol 1e-12 (the scans associate differently); frame grids
bit-equal; time_stretch and pitch_shift at the JAX package's own rtol
1e-6, atol 1e-8 against the oracle and against JAX; float32 >= 60 dB
against the float64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu import api as jax_api
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.effects import phase_vocoder as jpv
from audiosignalprocess_tpu_torch import api
from audiosignalprocess_tpu_torch.effects import phase_vocoder as pv
from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
from audiosignalprocess_tpu_torch.kernels import fft_kernel
from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac

ALG = dict(rtol=1e-10, atol=1e-12)
JAX_BAR = dict(rtol=1e-6, atol=1e-8)  # tests/unit/test_effects.py


@pytest.fixture()
def rng():
    return np.random.default_rng(83)


def _tone(n, f=440.0, fs=48000):
    return np.sin(2 * np.pi * f * np.arange(n) / fs)


def _snr(ref, got):
    return oracle.snr_db(np.asarray(ref, np.float64) + 1e-30,
                         np.asarray(got, np.float64) + 1e-30)


# ---------------------------------------------------------------------------
# rotor algebra and frame grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", (np.float64, np.float32))
def test_unit_rotor_vs_jax(rng, dtype):
    """Unit rotors equal JAX's; |z|^2 <= 1e-36 (zeros, 1e-19 values) maps
    to the neutral rotor 1+0j."""
    zr = rng.standard_normal((3, 50)).astype(dtype)
    zi = rng.standard_normal((3, 50)).astype(dtype)
    zr[0, :5], zi[0, :5] = 0.0, 0.0
    zr[1, :3], zi[1, :3] = 1e-19, -1e-19
    pr, pi = pv.unit_rotor(torch.as_tensor(zr), torch.as_tensor(zi))
    jr, ji = jpv.unit_rotor(jnp.asarray(zr), jnp.asarray(zi))
    tol = ALG if dtype == np.float64 else dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), **tol)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), **tol)
    assert pr.dtype == torch.from_numpy(zr).dtype
    np.testing.assert_array_equal(pr.numpy()[0, :5], 1.0)
    np.testing.assert_array_equal(pi.numpy()[0, :5], 0.0)
    np.testing.assert_array_equal(pr.numpy()[1, :3], 1.0)
    np.testing.assert_allclose(np.hypot(pr.numpy()[2], pi.numpy()[2]), 1.0, rtol=1e-6)


@pytest.mark.parametrize("frames,axis", ((1, -2), (2, -2), (37, -2), (13, 0)))
def test_cumrotor_vs_jax(rng, frames, axis):
    """The Hillis-Steele scan equals JAX's associative_scan (and the
    sequential product) to float64 reassociation."""
    shape = (frames, 2, 9) if axis == 0 else (2, frames, 9)
    ph = rng.uniform(-np.pi, np.pi, shape)
    ur, ui = np.cos(ph), np.sin(ph)
    cr, ci = pv.cumrotor(torch.as_tensor(ur), torch.as_tensor(ui), axis=axis)
    jr, ji = jpv.cumrotor(jnp.asarray(ur), jnp.asarray(ui), axis=axis)
    np.testing.assert_allclose(cr.numpy(), np.asarray(jr), **ALG)
    np.testing.assert_allclose(ci.numpy(), np.asarray(ji), **ALG)
    seq = np.cumprod(ur + 1j * ui, axis=axis)
    np.testing.assert_allclose(cr.numpy() + 1j * ci.numpy(), seq, **ALG)


def test_wrap_vs_jax(rng):
    p = rng.uniform(-40.0, 40.0, 200)
    np.testing.assert_allclose(pv._wrap(torch.as_tensor(p)).numpy(),
                               np.asarray(jpv._wrap(jnp.asarray(p))), **ALG)


@pytest.mark.parametrize("p,q", ((3, 4), (4, 3), (1, 2), (2, 1), (147, 160), (63, 50)))
def test_stretch_steps_rational_bit_equal(p, q):
    for nf in (0, 1, 2, 3, 17, 100, 1001):
        k, f = pv.stretch_steps_rational(nf, p, q)
        jk, jf = jpv.stretch_steps_rational(nf, p, q)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize("n,rate", ((16384, 0.5), (16384, 1.0), (16384, 1.7), (48000, 0.75),
                                    (5000, 2.0), (1024, 1.0)))
def test_output_frames_vs_jax(n, rate):
    assert pv.output_frames(n, rate, 1024, 256) == jpv.output_frames(n, rate, 1024, 256)


def _spec(rng, frames=40, bins=33):
    return (rng.standard_normal((2, frames, bins))
            + 1j * rng.standard_normal((2, frames, bins)))


@pytest.mark.parametrize("rate", (0.75, 1.7))
def test_stretch_spec_vs_jax(rng, rate):
    s = _spec(rng)
    got = pv.stretch_spec(torch.as_tensor(s), rate, 64, 16)
    want = np.asarray(jpv.stretch_spec(jnp.asarray(s), rate, 64, 16))
    assert got.shape == want.shape and got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, **ALG)


@pytest.mark.parametrize("p,q", ((4, 3), (147, 160)))
def test_stretch_spec_rational_vs_jax(rng, p, q):
    s = _spec(rng, frames=60)
    got = pv.stretch_spec_rational(torch.as_tensor(s), p, q, 64, 16)
    want = np.asarray(jpv.stretch_spec_rational(jnp.asarray(s), p, q, 64, 16))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **ALG)


def test_stretch_spec_float32_stays_complex64(rng):
    s = _spec(rng).astype(np.complex64)
    got = pv.stretch_spec(torch.as_tensor(s), 0.75, 64, 16)
    assert got.dtype == torch.complex64
    want = np.asarray(jpv.stretch_spec(jnp.asarray(s.astype(np.complex128)), 0.75, 64, 16))
    assert _snr(np.stack([want.real, want.imag]), np.stack([got.real, got.imag])) >= 100.0


# ---------------------------------------------------------------------------
# time stretch and pitch shift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", (0.5, 1.0, 1.7))
def test_time_stretch_vs_jax_and_oracle(rng, rate):
    """The JAX test's tone, and beside it a second channel of the tone in
    white noise."""
    x = _tone(16384)
    x = np.stack([x, x + 0.3 * rng.standard_normal(16384)])
    out = pv.time_stretch(torch.as_tensor(x), rate).numpy()
    ref = oracle.time_stretch(x, rate)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **JAX_BAR)
    np.testing.assert_allclose(out, np.asarray(jpv.time_stretch(jnp.asarray(x), rate)),
                               **JAX_BAR)


def test_stretch_length():
    x = torch.as_tensor(_tone(48000))
    assert 0.4 < pv.time_stretch(x, 2.0).shape[-1] / 48000 < 0.6
    assert 1.8 < pv.time_stretch(x, 0.5).shape[-1] / 48000 < 2.2


def test_pitch_shift_vs_jax_and_oracle():
    x = _tone(16384)
    out = pv.pitch_shift(torch.as_tensor(x), 3.0).numpy()
    ref = oracle.pitch_shift(x, 3.0)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **JAX_BAR)
    np.testing.assert_allclose(out, np.asarray(jpv.pitch_shift(jnp.asarray(x), 3.0)),
                               **JAX_BAR)


def test_pitch_shift_moves_peak():
    fs = 48000
    y = pv.pitch_shift(torch.as_tensor(_tone(fs)), 12.0).numpy()  # +1 octave
    seg = y[8192 : 8192 + 16384]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert abs(np.argmax(spec) * fs / len(seg) - 880.0) < 25.0


@pytest.mark.parametrize("semitones", (3.0, -5.0))
def test_pitch_shift_float32_runs_resample_mac_plain_on_cpu(rng, semitones):
    """float32 resamples through ``resample_mac`` (its plain version on a
    CPU tensor: no launch), >= 60 dB against the float64 oracle."""
    x = _tone(16384) + 0.1 * rng.standard_normal(16384)
    before = (resample_mac.launches, fft_kernel.rfft_stockham.launches)
    y = pv.pitch_shift(torch.as_tensor(x.astype(np.float32)), semitones)
    assert y.dtype == torch.float32
    assert (resample_mac.launches, fft_kernel.rfft_stockham.launches) == before
    assert _snr(oracle.pitch_shift(x.astype(np.float32).astype(np.float64), semitones),
                y.numpy()) >= 60.0


def test_pitch_shift_float32_takes_the_kernel_route(monkeypatch, rng):
    """float32 calls ``resample_mac``; float64 never does."""
    from audiosignalprocess_tpu_torch.kernels import resample_kernel

    calls = []
    real = resample_kernel.resample_mac

    def spy(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(resample_kernel, "resample_mac", spy)
    x = rng.standard_normal((2, 8192))
    pv.pitch_shift(torch.as_tensor(x), 2.0)
    assert calls == []
    pv.pitch_shift(torch.as_tensor(x.astype(np.float32)), 2.0)
    assert calls == [torch.float32]


# ---------------------------------------------------------------------------
# the one-shots
# ---------------------------------------------------------------------------

@pytest.fixture()
def tone_wav(tmp_path, rng):
    fs = 16000
    x = 0.5 * _tone(32000, fs=fs) + 0.01 * rng.standard_normal(32000)
    x = np.stack([x, np.roll(x, 999)]).astype(np.float32)
    p = str(tmp_path / "tone.wav")
    write_wav(p, x, fs, float_fmt=True)
    return p, fs


@pytest.mark.parametrize("name,kw", (("time_stretch_file", dict(rate_factor=2.0)),
                                     ("time_stretch_file", dict(rate_factor=0.8)),
                                     ("pitch_shift_file", dict(semitones=12.0)),
                                     ("pitch_shift_file", dict(semitones=-3.0))))
def test_one_shot_vs_jax(tone_wav, tmp_path, name, kw):
    """On device="cpu" the port writes what the JAX one-shot writes from
    the same WAV (float32 on both sides, >= 100 dB), at the input's rate."""
    p, fs = tone_wav
    out, jout = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    shape = getattr(api, name)(p, out, device="cpu", float_fmt=True, **kw)
    jshape = getattr(jax_api, name)(p, jout, float_fmt=True, **kw)
    y, rate = read_wav(out, dtype=np.float64)
    yj, _ = read_wav(jout, dtype=np.float64)
    assert tuple(shape) == tuple(jshape) == y.shape and rate == fs
    assert _snr(yj, y) >= 100.0


def test_time_stretch_file_length_and_pitch_peak(tone_wav, tmp_path):
    """The JAX api tests' behaviour: rate 2 halves the length; +12
    semitones moves the 440 Hz tone to 880 Hz."""
    p, fs = tone_wav
    out = str(tmp_path / "ts.wav")
    api.time_stretch_file(p, out, rate_factor=2.0, device="cpu")
    y, _ = read_wav(out)
    assert 0.4 < y.shape[-1] / 32000 < 0.6
    api.pitch_shift_file(p, out, semitones=12.0, device="cpu")
    y, _ = read_wav(out, dtype=np.float64)
    seg = y[0, 8192 : 8192 + 8192] * np.hanning(8192)
    spec = np.abs(np.fft.rfft(seg))
    f = np.fft.rfftfreq(8192, 1 / fs)
    assert spec[np.argmin(abs(f - 880))] > 5 * spec[np.argmin(abs(f - 440))]


def test_vocoder_one_shots_default_to_the_card(tone_wav, tmp_path):
    """Without device=..., the vocoder one-shots run on CUDA: with no card
    they raise torch's own error and never fall back to the CPU."""
    import inspect

    for fn in (api.time_stretch_file, api.pitch_shift_file):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    p, _ = tone_wav
    for fn, kw in ((api.time_stretch_file, dict(rate_factor=1.25)),
                   (api.pitch_shift_file, dict(semitones=3.0))):
        with pytest.raises((AssertionError, RuntimeError)):
            fn(p, str(tmp_path / "out.wav"), **kw)
        assert not (tmp_path / "out.wav").exists()

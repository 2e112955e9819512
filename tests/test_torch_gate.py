"""The port's whole-file noise gate (kernels/gate_kernel.noise_gate_fused,
GateStage(fused=True).full), its one-shots in ``api`` and the pinning of
every plain version to torch.fft, on the CPU, against the oracle and the
JAX package (Pallas in interpret mode).

Tolerances: float64 to rtol 1e-8 / atol 1e-10 (the JAX gate kernel's own
bar against the oracle).  float32 gates >= 60 dB: the gate's decisions
are hard thresholds, so a float32 rounding flips a few borderline bins
(ROADMAP Queue 3); each float32 case is judged on several seeds and
reports its flipped bins.  Linear one-shots >= 100 dB."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu import api as jax_api
from audiosignalprocess_tpu import pipeline as jax_pipeline
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.io.wav import read_wav as jax_read_wav
from audiosignalprocess_tpu.kernels.gate_kernel import noise_gate_fused as jax_gate_fused
from audiosignalprocess_tpu_torch import api, pipeline
from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
from audiosignalprocess_tpu_torch.kernels import chain_kernel, fft_kernel, gate_kernel
from audiosignalprocess_tpu_torch.kernels import os_kernel, res_chain_kernel
from audiosignalprocess_tpu_torch.kernels.gate_kernel import noise_gate_fused, noise_gate_ref
from audiosignalprocess_tpu_torch.ops import fft
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.ops.stft import stft

F64 = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture()
def rng():
    return np.random.default_rng(43)


def _mk(rng, c, n, fs=48000):
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.25 * n / fs) & (t < 0.7 * n / fs),
                  np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


def _flips(x, nfft=1024, hop=256, noise_frames=8, threshold_db=6.0):
    """Bins whose gate decision float32 rounding flips on x (float32 stft
    against float64)."""
    dec = []
    for dt in (torch.float32, torch.float64):
        mag = stft(torch.as_tensor(x).to(dt), nfft, hop).abs()
        floor = mag[..., :noise_frames, :].mean(dim=-2, keepdim=True)
        dec.append(mag > floor * 10.0 ** (threshold_db / 20.0))
    return int((dec[0] != dec[1]).sum())


# ---------------------------------------------------------------------------
# twins of tests/kernels/test_gate_kernel.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (48128, 32768, 16384 + 256 * 3))
def test_vs_oracle_f64(rng, n):
    x = _mk(rng, 2, n)
    ref = np.stack([oracle.noise_gate(x[c]) for c in range(2)])
    out = noise_gate_fused(torch.as_tensor(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **F64)


def test_f32_snr(rng):
    x = _mk(rng, 4, 32768).astype(np.float32)
    ref = np.stack([oracle.noise_gate(x[c].astype(np.float64)) for c in range(4)])
    out = noise_gate_fused(torch.as_tensor(x))
    assert out.dtype == torch.float32
    assert oracle.snr_db(ref, out.numpy()) >= 60.0


def test_odd_batch(rng):
    x = _mk(rng, 3, 16384)
    ref = np.stack([oracle.noise_gate(x[c]) for c in range(3)])
    np.testing.assert_allclose(noise_gate_fused(torch.as_tensor(x)).numpy(), ref, **F64)


def test_params(rng):
    x = _mk(rng, 1, 16384)
    kw = dict(nfft=512, hop=128, threshold_db=10.0, reduction_db=40.0, noise_frames=4,
              window_kind="hamming")
    ref = oracle.noise_gate(x[0], **kw)
    np.testing.assert_allclose(noise_gate_fused(torch.as_tensor(x), **kw).numpy()[0],
                               ref, **F64)


def test_nfft_2048(rng):
    x = _mk(rng, 2, 32768 + 777)
    ref = np.stack([oracle.noise_gate(x[c], nfft=2048, hop=512) for c in range(2)])
    out = noise_gate_fused(torch.as_tensor(x), nfft=2048, hop=512).numpy()
    assert out.shape == ref.shape == (2, 2048 + ((32768 + 777 - 2048) // 512) * 512)
    np.testing.assert_allclose(out, ref, **F64)


@pytest.mark.parametrize("release", (0.5, 0.9))
def test_release_smoothing(rng, release):
    x = _mk(rng, 2, 32768)
    ref = np.stack([oracle.noise_gate(x[c], release=release) for c in range(2)])
    np.testing.assert_allclose(noise_gate_fused(torch.as_tensor(x), release=release).numpy(),
                               ref, **F64)


def test_guards_and_no_launch_on_cpu(rng):
    with pytest.raises(ValueError, match="noise_frames"):
        noise_gate_fused(torch.zeros(1, 4096), noise_frames=32)
    with pytest.raises(ValueError, match="divide"):
        noise_gate_fused(torch.zeros(1, 8192), nfft=1024, hop=300)
    with pytest.raises(ValueError, match="too short"):
        noise_gate_fused(torch.zeros(1, 1024 + 256 * 4), noise_frames=2)
    before = noise_gate_fused.launches
    noise_gate_fused(torch.as_tensor(_mk(rng, 1, 8192)))
    assert noise_gate_fused.launches == before


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("release,nfft,hop,n", [(0.0, 1024, 256, 32768),
                                                (0.9, 1024, 256, 24576 + 333),
                                                (0.0, 2048, 512, 40960)])
def test_vs_jax_kernel_f64(release, nfft, hop, n):
    """JAX noise_gate_fused (interpret) against the port's, float64."""
    x = _mk(np.random.default_rng(44), 2, n)
    ref = np.asarray(jax_gate_fused(jnp.asarray(x), nfft, hop, release=release))
    out = noise_gate_fused(torch.as_tensor(x), nfft, hop, release=release).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **F64)


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_vs_jax_kernel_f32_seeds(seed):
    """float32, three seeds: >= 60 dB against the JAX kernel, with the
    bins float32 rounding flips counted."""
    x = _mk(np.random.default_rng(seed), 2, 24576).astype(np.float32)
    ref = np.asarray(jax_gate_fused(jnp.asarray(x)))
    out = noise_gate_fused(torch.as_tensor(x))
    snr = oracle.snr_db(ref.astype(np.float64), out.numpy())
    assert snr >= 60.0, f"seed {seed}: {snr:.2f} dB, {_flips(x)} flipped bins"


@pytest.mark.parametrize("release", (0.0, 0.6))
def test_gate_stage_fused_full_vs_jax(release):
    """JAX Chain([GateStage(fused=True)]).full against the port's, built
    from the JAX stage's fields (float64: the port's plain path)."""
    jax_stage = jax_pipeline.GateStage(noise_frames=4, release=release, fused=True)
    jchain = jax_pipeline.Chain([jax_stage])
    chain = pipeline.Chain.from_params([dict(dataclasses.asdict(jax_stage), stage="GateStage")])
    assert chain.stages[0].fused and chain.build() == jchain.build()
    x = _mk(np.random.default_rng(45), 2, 20000)
    ref = np.asarray(jchain.full(jnp.asarray(x)))
    out = chain.full(torch.as_tensor(x))
    assert out.shape == ref.shape == (2, 20000)
    np.testing.assert_allclose(out.numpy(), ref, **F64)
    x32 = x.astype(np.float32)
    assert oracle.snr_db(np.asarray(jchain.full(jnp.asarray(x32)), np.float64),
                         chain.full(torch.as_tensor(x32)).numpy()) >= 60.0


def test_gate_stage_routes(rng):
    """float32 through noise_gate_fused (its plain version on the CPU),
    float64 through the plain gate; fused=False with impl through ops.fft."""
    x = torch.as_tensor(_mk(rng, 2, 9000))
    st = pipeline.GateStage(noise_frames=4, fused=True)
    ref32 = noise_gate_ref(x.float(), noise_frames=4)
    y32 = st.full(x.float())
    assert torch.equal(y32[:, : ref32.shape[-1]], ref32)
    assert torch.count_nonzero(y32[:, ref32.shape[-1]:]) == 0
    plain = pipeline.GateStage(noise_frames=4, impl="radix2").full(x)
    np.testing.assert_allclose(st.full(x).numpy(), plain.numpy(), **F64)


# ---------------------------------------------------------------------------
# the api one-shots against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw,bar", [
    ("noise_gate_file", dict(noise_frames=4), 60.0),
    ("lowpass_file", dict(cutoff_hz=3000.0), 100.0),
    ("bandpass_file", dict(lo_hz=300.0, hi_hz=3000.0, numtaps=128), 100.0),
    ("envelope_file", dict(cutoff_hz=50.0), 100.0),
])
def test_one_shot_vs_jax(tmp_path, name, kw, bar):
    x = _mk(np.random.default_rng(46), 2, 24000).astype(np.float32) * 0.5
    p = str(tmp_path / "in.wav")
    write_wav(p, x, 48000, float_fmt=True)
    out, ref = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    shape = getattr(api, name)(p, out, device="cpu", float_fmt=True, **kw)
    getattr(jax_api, name)(p, ref, float_fmt=True, **kw)
    y, rate = read_wav(out, dtype=np.float64)
    y_ref, rate_ref = jax_read_wav(ref, dtype=np.float64)
    assert rate == rate_ref == 48000 and y.shape == y_ref.shape == shape
    assert oracle.snr_db(y_ref, y) >= bar


def test_one_shots_default_to_the_card(tmp_path):
    """Without device=..., a one-shot runs on CUDA: with no card it raises
    torch's own error and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    p = str(tmp_path / "in.wav")
    write_wav(p, _mk(np.random.default_rng(47), 1, 8192).astype(np.float32), 48000)
    for fn, kw in ((api.noise_gate_file, {}), (api.lowpass_file, dict(cutoff_hz=2000.0)),
                   (api.chain_file, {}), (api.resample_file, dict(rate_out=44100))):
        with pytest.raises((AssertionError, RuntimeError)):
            fn(p, str(tmp_path / "out.wav"), **kw)
        assert not (tmp_path / "out.wav").exists()


# ---------------------------------------------------------------------------
# plain versions and prologues never take the Stockham route
# ---------------------------------------------------------------------------

def test_plain_versions_are_pinned_to_torch(monkeypatch, rng):
    """With ``auto`` forced to the Stockham route (as on a CUDA float32
    tensor) and the Stockham wrappers made to fail, every plain version
    and prologue still runs: each pins its FFTs to torch.fft."""
    resolve = fft._resolve_impl
    monkeypatch.setattr(fft, "_resolve_impl",
                        lambda impl, x: "stockham" if impl == "auto" else resolve(impl, x))

    def fail(*a, **k):
        raise AssertionError("a plain version reached the Stockham kernels")

    for name in ("fft_stockham_lanes", "rfft_stockham", "irfft_stockham"):
        monkeypatch.setattr(fft_kernel, name, fail)
    x = torch.as_tensor(_mk(rng, 2, 16 * 1176).astype(np.float32))
    with pytest.raises(AssertionError, match="Stockham"):
        fft.rfft(x[:, :4096])  # the control: auto now takes the kernels
    h, gate = design_fir(64, 0.3), dict(nfft=1024, hop=256, noise_frames=4)
    win = torch.hann_window(1024, periodic=True)
    os_kernel.overlap_save_ref(x, h, 1024)
    chain_kernel.fir_noise_gate_ref(x, h, noise_frames=4, release=0.6)
    chain_kernel.filtered_floor(x[:, :4096], h, 1024, 256, 4, win)
    gate_kernel.noise_gate_ref(x, noise_frames=4, release=0.6)
    gate_kernel.noise_floor(x[:, :4096].unfold(-1, 1024, 256) * win)
    res_chain_kernel.resample_fir_gate_ref(x, 160, 147, h, noise_frames=4)
    stage = pipeline.GateStage(**gate)
    stage.configure(0)
    st = stage.init_state((2,), 2048)
    gate_kernel.gate_step_ref(x[:, :2048], st, **stage._step_kw())
    fg = pipeline.FIRGateStage(h=h, **gate)
    fg.configure(0)
    chain_kernel.fir_gate_step_ref(x[:, :2048], fg.init_state((2,), 2048), h,
                                   **fg._gate._step_kw())
    rs = pipeline.ResFIRGateStage(h=h, **gate)
    rs.configure(0)
    res_chain_kernel.res_fir_gate_step_ref(x[:, :1176], rs.init_state((2,), 1176), 160, 147,
                                           h, rs.h_res, **rs._fg._gate._step_kw())

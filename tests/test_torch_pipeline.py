"""The port's Chain (whole file, and from_params) and api.chain_file vs
the JAX package."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu import api as jax_api
from audiosignalprocess_tpu import pipeline as jax_pipeline
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.io.wav import read_wav as jax_read_wav
from audiosignalprocess_tpu_torch import api, pipeline
from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
from audiosignalprocess_tpu_torch.kernels import _build
from audiosignalprocess_tpu_torch.kernels.chain_kernel import fir_noise_gate_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _signal(rng, c, n, fs=48000):
    t = np.arange(n) / fs
    return 0.01 * rng.standard_normal((c, n)) + np.where(
        (t > 0.3 * n / fs) & (t < 0.6 * n / fs), 0.5 * np.sin(2 * np.pi * 440.0 * t), 0.0)


@pytest.mark.parametrize("release", (0.0, 0.6))
def test_chain_from_params_vs_jax(release):
    rng = np.random.default_rng(21)
    jax_stage = jax_pipeline.FIRGateStage(
        h=oracle.design_fir(64, 0.3), nfft=1024, hop=256, noise_frames=4,
        release=release)
    params = [dataclasses.asdict(jax_stage)]
    jchain = jax_pipeline.Chain([jax_stage])
    chain = pipeline.Chain.from_params(params)
    assert chain.build() == jchain.build()
    x = _signal(rng, 2, 20000)
    ref = np.asarray(jchain.full_flush(jnp.asarray(x)))
    out = chain.full_flush(torch.as_tensor(x))
    assert out.shape == ref.shape == (2, 20000)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-8, atol=1e-10)
    for n in (4096, 20000, 48000, 77777):
        assert chain.out_len(n) == jchain.out_len(n)


def test_f32_routes_through_fused_wrapper():
    """float32 goes through fir_noise_gate_fused (its plain version on a
    CPU tensor), float64 through the composed FIRStage -> GateStage."""
    rng = np.random.default_rng(22)
    h = oracle.design_fir(64, 0.3)
    chain = pipeline.Chain([pipeline.FIRGateStage(h=h, noise_frames=4)])
    chain.build()
    x = torch.as_tensor(_signal(rng, 2, 9000))
    y32 = chain.full_flush(x.float())
    ref32 = fir_noise_gate_ref(x.float(), h, noise_frames=4)
    assert y32.dtype == torch.float32
    assert torch.equal(y32[:, : ref32.shape[-1]], ref32)
    assert torch.count_nonzero(y32[:, ref32.shape[-1]:]) == 0
    y64 = chain.full_flush(x)
    composed = pipeline.GateStage(noise_frames=4).full(
        pipeline.FIRStage(h=h, nfft=1024).full(x))
    assert torch.equal(y64, composed)


def test_from_params_rejects_what_is_not_ported():
    """A stage name the port does not know raises; the phase vocoder's
    StretchStage, once missing, now carries over from the JAX stage's
    fields (and computes like it, float64); so does a JAX GateStage with
    fused=True, whose whole-file noise_gate_fused once was missing."""
    with pytest.raises(ValueError, match="unknown stage"):
        pipeline.Chain.from_params([dict(stage="PhaseShifterStage")])
    assert {"ResampleStage", "ResFIRGateStage", "StretchStage"} <= set(pipeline.STAGES)
    jax_stretch = jax_pipeline.StretchStage(p=3, q=4, fused=True)
    chain = pipeline.Chain.from_params(
        [dict(dataclasses.asdict(jax_stretch), stage="StretchStage")])
    st = chain.stages[0]
    assert isinstance(st, pipeline.StretchStage) and (st.p, st.q, st.fused) == (3, 4, True)
    xs = np.random.default_rng(27).standard_normal((2, 9000))
    np.testing.assert_allclose(
        chain.full_flush(torch.as_tensor(xs)).numpy(),
        np.asarray(jax_pipeline.Chain([jax_stretch]).full_flush(jnp.asarray(xs))),
        rtol=1e-8, atol=1e-10)
    jax_stage = jax_pipeline.GateStage(noise_frames=4, fused=True)
    chain = pipeline.Chain.from_params([dict(dataclasses.asdict(jax_stage), stage="GateStage")])
    assert chain.stages[0].fused and chain.stages[0].impl == "auto"
    x = _signal(np.random.default_rng(28), 2, 9000)
    np.testing.assert_allclose(
        chain.full_flush(torch.as_tensor(x)).numpy(),
        np.asarray(jax_pipeline.Chain([jax_stage]).full_flush(jnp.asarray(x))),
        rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("release", (0.0, 0.6))
def test_from_params_env_h_streams_like_jax(release):
    """A JAX FIRGateStage with the envelope fold carried across: whole
    file and drained stream equal the JAX chain's (float64)."""
    rng = np.random.default_rng(24)
    jax_stage = jax_pipeline.FIRGateStage(
        h=oracle.design_fir(64, 0.3), noise_frames=4, release=release,
        env_h=oracle.design_fir(129, 0.05), fused=False)
    jchain = jax_pipeline.Chain([jax_stage])
    chain = pipeline.Chain.from_params([dataclasses.asdict(jax_stage)])
    assert chain.build() == jchain.build()
    x = _signal(rng, 2, 12000)
    np.testing.assert_allclose(chain.full_flush(torch.as_tensor(x)).numpy(),
                               np.asarray(jchain.full_flush(jnp.asarray(x))),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        chain.stream(torch.as_tensor(x), 2048, drain=True).numpy(),
        np.asarray(jchain.stream(jnp.asarray(x), 2048, drain=True)),
        rtol=1e-8, atol=1e-10)


def test_chain_file_vs_jax(tmp_path):
    rng = np.random.default_rng(23)
    x = _signal(rng, 2, 24000).astype(np.float32)
    p = str(tmp_path / "in.wav")
    write_wav(p, x, 48000)
    out, ref = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    shape = api.chain_file(p, out, rate_out=48000, noise_frames=4, device="cpu")
    jax_api.chain_file(p, ref, rate_out=48000, noise_frames=4)
    y, rate = read_wav(out, dtype=np.float64)
    y_ref, rate_ref = jax_read_wav(ref, dtype=np.float64)
    assert rate == rate_ref == 48000 and y.shape == y_ref.shape == shape == (2, 24000)
    assert np.max(np.abs(y - y_ref)) * 32768 <= 1.0


@pytest.mark.parametrize("kw", [dict(rate=48000, rate_out=44100),
                                dict(rate=44100, rate_out=48000, block=4704),
                                dict(rate=44100, rate_out=48000, envelope_hz=50.0)])
def test_chain_file_not_ported_raises(tmp_path, kw):
    """The resampler front end (a file not at rate_out), once missing from
    the port, now runs: whole file, block-streamed and with the envelope,
    against the JAX api.chain_file (16-bit output within one LSB)."""
    kw = dict(kw)
    rate = kw.pop("rate")
    rng = np.random.default_rng(26)
    x = _signal(rng, 2, 14112, fs=rate).astype(np.float32)
    p = str(tmp_path / "in.wav")
    write_wav(p, x, rate)
    out, ref = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    shape = api.chain_file(p, out, noise_frames=4, device="cpu", **kw)
    jax_api.chain_file(p, ref, noise_frames=4, **kw)
    y, rate_y = read_wav(out, dtype=np.float64)
    y_ref, rate_ref = jax_read_wav(ref, dtype=np.float64)
    n_out = -(-14112 * kw["rate_out"] // rate)
    assert rate_y == rate_ref == kw["rate_out"]
    assert y.shape == y_ref.shape == shape == (2, n_out)
    assert np.max(np.abs(y - y_ref)) * 32768 <= 1.0


@pytest.mark.parametrize("rate,rate_out", [(44100, 48000), (48000, 44100), (48000, 24000)])
def test_resample_file_vs_jax(tmp_path, rate, rate_out):
    """api.resample_file (zero-phase polyphase) against the JAX one."""
    rng = np.random.default_rng(27)
    x = _signal(rng, 2, 9000, fs=rate).astype(np.float32)
    p = str(tmp_path / "in.wav")
    write_wav(p, x, rate, float_fmt=True)
    out, ref = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    shape = api.resample_file(p, out, rate_out, device="cpu", float_fmt=True)
    jax_api.resample_file(p, ref, rate_out, float_fmt=True)
    y, rate_y = read_wav(out, dtype=np.float64)
    y_ref, rate_ref = jax_read_wav(ref, dtype=np.float64)
    assert rate_y == rate_ref == rate_out and y.shape == y_ref.shape == shape
    assert oracle.snr_db(y_ref, y) >= 100.0


@pytest.mark.parametrize("kw", [dict(block=2048), dict(envelope_hz=50.0),
                                dict(block=4096, envelope_hz=50.0)])
def test_chain_file_streaming_and_envelope_vs_jax(tmp_path, kw):
    rng = np.random.default_rng(25)
    x = _signal(rng, 2, 24000).astype(np.float32)
    p = str(tmp_path / "in.wav")
    write_wav(p, x, 48000)
    out, ref = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    shape = api.chain_file(p, out, noise_frames=4, device="cpu", **kw)
    jax_api.chain_file(p, ref, noise_frames=4, **kw)
    y, rate = read_wav(out, dtype=np.float64)
    y_ref, _ = jax_read_wav(ref, dtype=np.float64)
    assert rate == 48000 and y.shape == y_ref.shape == shape == (2, 24000)
    assert np.max(np.abs(y - y_ref)) * 32768 <= 1.0


def _run(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, **env}, capture_output=True, text=True)


def test_port_imports_no_jax():
    proc = _run("import audiosignalprocess_tpu_torch, audiosignalprocess_tpu_torch.api, "
                "audiosignalprocess_tpu_torch.pipeline, "
                "audiosignalprocess_tpu_torch.utils.checkpoint, sys; "
                "assert 'jax' not in sys.modules")
    assert proc.returncode == 0, proc.stderr


def test_kernel_module_imports_without_nvcc():
    proc = _run("from audiosignalprocess_tpu_torch.kernels import chain_kernel as ck, "
                "gate_kernel as gk, fir_kernel as fk, os_kernel as ok, "
                "resample_kernel as rk, res_chain_kernel as rc, fft_kernel as ff; "
                "assert gk.noise_gate_fused.launches == 0; "
                "assert ff.fft_stockham_lanes.launches == 0; "
                "assert ff.rfft_stockham.launches == 0; "
                "assert ff.irfft_stockham.launches == 0; "
                "assert ck.fir_noise_gate_fused.launches == 0; "
                "assert ck.fir_gate_step_fused.launches == 0; "
                "assert gk.gate_step_fused.launches == 0; "
                "assert fk.fir_mac.launches == 0; "
                "assert ok.overlap_save_fused.launches == 0; "
                "assert rk.resample_mac.launches == 0; "
                "assert rc.resample_fir_gate_fused.launches == 0; "
                "assert rc.res_fir_gate_step_fused.launches == 0",
                PATH=os.path.dirname(sys.executable), CUDA_HOME=os.devnull)
    assert proc.returncode == 0, proc.stderr


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()

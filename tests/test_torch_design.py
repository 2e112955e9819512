"""Design-time numpy helpers of the port are bit-equal to the JAX package's.

The port carries its own copies (importing any module of the JAX package
imports jax), so these tests keep the spec single.
"""

import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.io import wav as jax_wav
from audiosignalprocess_tpu.kernels import gate_kernel as jax_gate
from audiosignalprocess_tpu.ops import resample as jax_resample
from audiosignalprocess_tpu_torch.io import wav
from audiosignalprocess_tpu_torch.kernels import chain_kernel, gate_kernel
from audiosignalprocess_tpu_torch.ops import fir, resample, stft, windows


@pytest.mark.parametrize("kind", windows.KINDS)
@pytest.mark.parametrize("periodic", (True, False))
def test_window_np(kind, periodic):
    for n in (1, 2, 63, 1024):
        assert np.array_equal(windows.window_np(kind, n, periodic),
                              oracle.window(kind, n, periodic=periodic))
    w = windows.window(kind, 256, periodic, dtype=torch.float64)
    assert np.array_equal(w.numpy(), oracle.window(kind, 256, periodic))


@pytest.mark.parametrize("args,kw", [
    ((64, 0.3), {}),
    ((384, 0.2), {}),
    ((1, 0.5), {}),
    ((129, 0.01), {"window_kind": "blackman"}),
    ((256, (0.1, 0.3)), {"window_kind": "hamming", "pass_zero": False}),
    ((101, 0.4), {"pass_zero": False}),
])
def test_design_fir(args, kw):
    assert np.array_equal(fir.design_fir(*args, **kw),
                          oracle.design_fir(*args, **kw))


@pytest.mark.parametrize("up,down,kw", [
    (160, 147, {}), (147, 160, {}), (2, 1, {}), (1, 2, {}), (3, 4, {}),
    (160, 147, {"half_width": 4, "window_kind": "blackman"}),
])
def test_resample_filter(up, down, kw):
    assert np.array_equal(resample.resample_filter(up, down, **kw),
                          oracle.resample_filter(up, down, **kw))


@pytest.mark.parametrize("up,down", [(160, 147), (147, 160), (2, 1), (3, 4)])
def test_resample_geometry(up, down):
    """taps_per_phase and history_len equal the JAX package's; the phase
    bank holds every tap once, bank[p, k] = h[p + up*k]."""
    h = oracle.resample_filter(up, down)
    assert resample.taps_per_phase(len(h), up) == jax_resample.taps_per_phase(len(h), up)
    assert (resample.history_len(len(h), up, down)
            == jax_resample.history_len(len(h), up, down))
    bank = resample.phase_bank(h, up)
    assert bank.shape == (up, resample.taps_per_phase(len(h), up))
    p, k = np.divmod(np.arange(len(h)), up)[::-1]
    assert np.array_equal(bank[p, k], h) and np.count_nonzero(bank) == np.count_nonzero(h)


def test_design_fir_rejects_like_oracle():
    for bad in ((64, 1.2), (64, 0.3, "hann", False)):
        with pytest.raises(ValueError):
            oracle.design_fir(*bad)
        with pytest.raises(ValueError):
            fir.design_fir(*bad)


def test_wola_clamp():
    rng = np.random.default_rng(3)
    norm = rng.random(4096) ** 4
    norm[:7] = 0.0
    assert np.array_equal(stft.wola_clamp(norm), oracle.wola_clamp(norm))
    assert stft.WOLA_EDGE_REL == oracle.WOLA_EDGE_REL


@pytest.mark.parametrize("nfft,hop,nframes", [(1024, 256, 20), (512, 128, 9),
                                              (256, 256, 5), (64, 16, 40)])
def test_inv_norm_rows(nfft, hop, nframes):
    wv = oracle.window("hann", nfft, periodic=True)
    total = nfft + (nframes - 1) * hop + 3 * hop
    assert np.array_equal(
        gate_kernel.inv_norm_rows(wv, nfft, hop, nframes, total),
        jax_gate.inv_norm_rows(wv, nfft, hop, nframes, total))


@pytest.mark.parametrize("nfft,hop,nframes", [(1024, 256, 1872), (1024, 256, 6),
                                              (256, 64, 50), (128, 128, 7)])
def test_inv_norm_table_maps_to_rows(nfft, hop, nframes):
    """The kernel's compact [head | period | tail] table, indexed the way
    csrc/chain_kernel.cu indexes it, reproduces every entry of the
    full-length vector exactly."""
    wv = oracle.window("hann", nfft, periodic=True)
    d = nfft - hop
    out_len = nfft + (nframes - 1) * hop
    full = jax_gate.inv_norm_rows(wv, nfft, hop, nframes, out_len)
    tab = chain_kernel._inv_norm_table(wv, nfft, hop)
    assert tab.shape == (2 * d + hop,)
    p = np.arange(out_len)
    idx = np.where(p < d, p, np.where(p >= out_len - d,
                                      d + hop + p - (out_len - d),
                                      d + p % hop))
    assert np.array_equal(tab[idx], full)


@pytest.mark.parametrize("bits,float_fmt", [(16, False), (24, False), (32, True)])
def test_wav_roundtrip(tmp_path, bits, float_fmt):
    rng = np.random.default_rng(5)
    x = np.clip(0.4 * rng.standard_normal((3, 1001)), -1, 1).astype(np.float32)
    p = str(tmp_path / "x.wav")
    wav.write_wav(p, x, 48000, bits=bits, float_fmt=float_fmt)
    got, rate = wav.read_wav(p)
    ref, ref_rate = jax_wav.read_wav(p)
    assert rate == ref_rate == 48000
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    # and the port's writer produces the JAX writer's bytes
    q = str(tmp_path / "y.wav")
    jax_wav.write_wav(q, x, 48000, bits=bits, float_fmt=float_fmt)
    assert open(p, "rb").read() == open(q, "rb").read()

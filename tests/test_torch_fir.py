"""The port's direct-form FIR, MAC and overlap-save kernels' plain paths
and the envelope effects vs the JAX package (Pallas in interpret mode)
and the float64 oracle.

On the CPU every wrapper runs its plain PyTorch version; the CUDA kernels
themselves are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.kernels.fir_kernel import fir_mac as jax_fir_mac
from audiosignalprocess_tpu.kernels.os_kernel import (
    overlap_save_fused as jax_overlap_save_fused,
)
from audiosignalprocess_tpu.ops.fir import fir_direct as jax_fir_direct
from audiosignalprocess_tpu_torch.effects import envelope
from audiosignalprocess_tpu_torch.kernels.chain_kernel import history_tail
from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac, fir_mac_ref
from audiosignalprocess_tpu_torch.kernels.os_kernel import overlap_save_fused
from audiosignalprocess_tpu_torch.ops.fir import fir_direct
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.utils.metrics import snr_db

# the JAX package's effects/__init__ binds the name ``envelope`` to the function
jax_envelope = importlib.import_module("audiosignalprocess_tpu.effects.envelope")
F64 = dict(rtol=1e-8, atol=1e-10)  # float64 port vs float64 JAX


@pytest.fixture()
def rng():
    return np.random.default_rng(61)


@pytest.mark.parametrize("taps", (1, 7, 64, 129))
@pytest.mark.parametrize("with_history", (False, True))
def test_fir_direct_vs_jax(rng, taps, with_history):
    x = rng.standard_normal((3, 2000))
    h = rng.standard_normal(taps)
    hist = rng.standard_normal((3, taps - 1)) if with_history else None
    ref = np.asarray(jax_fir_direct(jnp.asarray(x), h,
                                    history=None if hist is None else jnp.asarray(hist)))
    out = fir_direct(torch.as_tensor(x), h,
                     history=None if hist is None else torch.as_tensor(hist))
    assert out.dtype == torch.float64 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **F64)


@pytest.mark.parametrize("taps", (1, 7, 64, 129))
def test_fir_mac_f32_vs_oracle(rng, taps):
    """Twin of tests/kernels/test_mac_kernels.py::TestFIRMac::test_vs_oracle."""
    x = rng.standard_normal((4, 4000)).astype(np.float32)
    h = rng.standard_normal(taps)
    ref = np.stack([oracle.fir_direct(x[i].astype(np.float64), h) for i in range(4)])
    out = fir_mac(torch.as_tensor(x), h)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert snr_db(ref, out) >= 100.0


def test_fir_mac_history_vs_jax(rng):
    """Twin of TestFIRMac::test_history: the port against the JAX Pallas
    kernel (interpret mode) with a random history."""
    x = rng.standard_normal((1, 1024))
    h = rng.standard_normal(17)
    hist = rng.standard_normal((1, 16))
    ref = np.asarray(jax_fir_mac(x, h, history=hist, time_tile=256))
    out = fir_mac(torch.as_tensor(x), h, history=torch.as_tensor(hist))
    np.testing.assert_allclose(out.numpy(), ref, **F64)
    full = oracle.fir_direct(np.concatenate([hist, x], axis=-1)[0], h)[16:]
    np.testing.assert_allclose(out.numpy()[0], full, rtol=1e-9, atol=1e-9)


def test_fir_mac_odd_sizes_vs_jax(rng):
    """Twin of TestFIRMac::test_odd_sizes."""
    x = rng.standard_normal((3, 777))
    h = rng.standard_normal(9)
    ref = np.asarray(jax_fir_mac(x, h, time_tile=256, batch_tile=2))
    np.testing.assert_allclose(fir_mac(torch.as_tensor(x), h).numpy(), ref, **F64)


@pytest.mark.parametrize("taps,block", ((129, 512), (33, 700), (1, 256)))
def test_fir_mac_streaming_history(rng, taps, block):
    """Block by block with the carried history == the whole signal (the
    streaming pattern of tests/kernels/test_mac_kernels.py::
    test_streaming_history, here for the FIR MAC)."""
    n = block * 6
    x = rng.standard_normal((2, n))
    h = oracle.design_fir(taps, 0.1) if taps > 1 else np.array([0.3])
    hist = torch.zeros(2, taps - 1, dtype=torch.float64)
    outs = []
    xt = torch.as_tensor(x)
    for k in range(0, n, block):
        blk = xt[:, k : k + block]
        outs.append(fir_mac(blk, h, history=hist))
        hist = history_tail(hist, blk, taps)
    ref = np.stack([oracle.fir_direct(x[i], h) for i in range(2)])
    np.testing.assert_allclose(torch.cat(outs, dim=-1).numpy(), ref, rtol=1e-8, atol=1e-8)


def test_os_history_streaming_vs_jax(rng):
    """Twin of tests/kernels/test_os_kernel.py::test_history_streaming: the
    port's overlap_save_fused block by block with history, against the
    JAX Pallas kernel (interpret mode) on the same blocks and the oracle."""
    x = rng.standard_normal(8192)
    h = oracle.design_fir(128, 0.2)
    hist_j = np.zeros((1, 127))
    hist_p = torch.zeros(1, 127, dtype=torch.float64)
    outs, refs = [], []
    for k in range(0, 8192, 2048):
        blk = x[None, k : k + 2048]
        refs.append(np.asarray(jax_overlap_save_fused(blk, h, 2048, history=hist_j,
                                                      blocks_per_step=2))[0])
        outs.append(overlap_save_fused(torch.as_tensor(blk), h, 2048, history=hist_p)[0])
        hist_j = np.concatenate([hist_j, blk], axis=-1)[:, -127:]
        hist_p = torch.cat([hist_p, torch.as_tensor(blk)], dim=-1)[:, -127:]
    out = torch.cat(outs).numpy()
    np.testing.assert_allclose(out, np.concatenate(refs), **F64)
    np.testing.assert_allclose(out, oracle.fir_direct(x, h), rtol=1e-8, atol=1e-8)


def test_fused_routes_equal_plain_on_cpu(rng):
    """fused=True on a CPU tensor runs the plain version and counts no
    launch."""
    x = torch.as_tensor(rng.standard_normal((2, 3000)).astype(np.float32))
    h = oracle.design_fir(64, 0.3)
    before = (fir_mac.launches, overlap_save_fused.launches)
    assert torch.equal(fir_direct(x, h, fused=True), fir_mac_ref(x, h))
    assert torch.equal(overlap_save(x, h, 1024, fused=True), overlap_save(x, h, 1024))
    assert (fir_mac.launches, overlap_save_fused.launches) == before


@pytest.mark.parametrize("fn", ("envelope", "am_demod"))
def test_envelope_vs_jax_and_oracle(fn):
    """Twins of tests/unit/test_effects.py::TestEnvelope."""
    fs = 16000
    t = np.arange(8000) / fs
    x = (1.0 + 0.5 * np.sin(2 * np.pi * 5.0 * t)) * np.sin(2 * np.pi * 1000.0 * t)
    h = envelope.default_envelope_fir(fs)
    np.testing.assert_array_equal(h, jax_envelope.default_envelope_fir(fs))
    out = getattr(envelope, fn)(torch.as_tensor(x), h).numpy()
    np.testing.assert_allclose(out, np.asarray(getattr(jax_envelope, fn)(x, h)), **F64)
    np.testing.assert_allclose(out, getattr(oracle, fn)(x, h), rtol=1e-8, atol=1e-8)


def test_envelope_tracks_modulation():
    fs = 16000
    t = np.arange(16000) / fs
    mod = 1.0 + 0.5 * np.sin(2 * np.pi * 5.0 * t)
    h = envelope.default_envelope_fir(fs)
    e = envelope.envelope(torch.as_tensor(mod * np.sin(2 * np.pi * 1000.0 * t)), h).numpy()
    d = (len(h) - 1) // 2
    err = e[2000:-2000] - mod[2000 - d : len(t) - 2000 - d]
    assert np.sqrt(np.mean(err ** 2)) < 0.02


def test_hilbert_envelope_vs_jax(rng):
    x = rng.standard_normal((2, 4096))
    out = envelope.hilbert_envelope(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_envelope.hilbert_envelope(x)), **F64)
    np.testing.assert_allclose(out[0], oracle.hilbert_envelope(x[0]), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("call", (
    lambda x: fir_mac(x, [0.5, 0.5]),
    lambda x: overlap_save_fused(x, [0.5, 0.5], 256),
))
def test_other_devices_raise(call):
    with pytest.raises(ValueError, match="CPU or CUDA"):
        call(torch.zeros(1, 512, device="meta"))

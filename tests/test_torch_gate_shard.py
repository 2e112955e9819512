"""The port's ``gate_shard_fused`` (one time shard of the sharded gate) and
its plain version ``gate_shard_ref`` against the JAX package's
``gate_shard_fused`` (Pallas in interpret mode, ``tests/conftest.py``) on
the same numpy inputs.

The JAX kernel takes the shard's frame validity as a boolean mask; the
port takes its length, a Python int (the mask is a prefix by
construction), so these tests also hold the count to the mask.  Bars:
float64 >= 150 dB on tone bursts (no bin near its threshold, so no
decision flips); float32 >= 60 dB, with the bins that float32 rounding
flips against float64 counted in the message (the gate's hard
thresholds, ROADMAP Queue 3 "by design").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.kernels import gate_kernel as jax_gate
from audiosignalprocess_tpu_torch.kernels import gate_kernel as gk
from audiosignalprocess_tpu_torch.ops.stft import frame
from audiosignalprocess_tpu_torch.ops.windows import window

NFFT, HOP, NOISE_FRAMES = 1024, 256, 8
D = NFFT - HOP


def _tone_bursts(rng, c, n):
    t = np.arange(n) / 48000
    x = 0.01 * rng.standard_normal((c, n))
    return x + np.where((t > 0.3 * n / 48000) & (t < 0.7 * n / 48000),
                        np.sin(2 * np.pi * 440.0 * t), 0.0)


def _shard(x, t, n_sh):
    """(x_ext, floor_half, valid mask, n_valid) of time shard t of n_sh, as
    ``parallel.sharded.gate_shard_body`` forms them: the shard and the next
    d samples (zeros past the file), shard 0's floor, frames that end
    inside the file."""
    n = x.shape[-1]
    l = n // n_sh
    xp = np.concatenate([x, np.zeros(x.shape[:-1] + (D,))], axis=-1)
    x_ext = xp[..., t * l : (t + 1) * l + D]
    head = torch.as_tensor(xp[..., : D + NOISE_FRAMES * HOP])
    w = window("hann", NFFT, periodic=True, dtype=torch.float64)
    floor = gk.noise_floor(frame(head, NFFT, HOP) * w).numpy()
    starts = t * l + HOP * np.arange(l // HOP)
    valid = starts <= n - NFFT
    n_valid = int(valid.sum())
    assert valid[:n_valid].all()  # a prefix
    return x_ext, floor, valid, n_valid


def _jax(x_ext, floor, valid, dtype):
    return np.asarray(jax_gate.gate_shard_fused(
        jnp.asarray(x_ext, dtype), jnp.asarray(floor, dtype), jnp.asarray(valid), NFFT, HOP,
        6.0, 60.0))


def _flips(x_ext, floor, n_valid):
    """Bins whose gate decision float32 rounding flips against float64."""
    dec = []
    for dt in (torch.float32, torch.float64):
        v = torch.as_tensor(x_ext[..., : (n_valid - 1) * HOP + NFFT], dtype=dt)
        w = window("hann", NFFT, periodic=True, dtype=dt)
        mag = torch.fft.rfft(frame(v, NFFT, HOP) * w).abs()
        dec.append(mag > torch.as_tensor(floor, dtype=dt)[..., None, :] * 10.0 ** 0.3)
    return int((dec[0] != dec[1]).sum())


# (shards, which shard): the file's start, a middle shard, and end shards
# with frames past the file's end (13 of 16 valid; 1 of 2; none of 2)
CASES = [(4, 4096, 0), (4, 4096, 2), (4, 4096, 3), (4, 512, 2), (4, 512, 3)]


@pytest.mark.parametrize("n_sh,l,t", CASES)
def test_f64_matches_jax(n_sh, l, t):
    x = _tone_bursts(np.random.default_rng(31 + t), 3, n_sh * l)
    x_ext, floor, valid, n_valid = _shard(x, t, n_sh)
    want = _jax(x_ext, floor, valid, jnp.float64)
    ref = gk.gate_shard_ref(torch.as_tensor(x_ext), torch.as_tensor(floor), n_valid, NFFT, HOP)
    before = gk.gate_shard_fused.launches
    fused = gk.gate_shard_fused(torch.as_tensor(x_ext), torch.as_tensor(floor), n_valid,
                                NFFT, HOP)
    assert gk.gate_shard_fused.launches == before  # the CPU runs the plain version
    assert ref.shape == fused.shape == want.shape == x_ext.shape
    np.testing.assert_array_equal(fused.numpy(), ref.numpy())
    if n_valid == 0:
        assert not want.any() and not ref.numpy().any()
        return
    assert oracle.snr_db(want, ref.numpy()) >= 150.0
    # past the last valid frame's end nothing is written
    np.testing.assert_array_equal(ref.numpy()[..., (n_valid - 1) * HOP + NFFT :], 0.0)


@pytest.mark.parametrize("t", (0, 3))
def test_f32_matches_jax(t):
    x = _tone_bursts(np.random.default_rng(41 + t), 3, 4 * 4096)
    x_ext, floor, valid, n_valid = _shard(x, t, 4)
    x32, f32 = x_ext.astype(np.float32), floor.astype(np.float32)
    want = _jax(x32, f32, valid, jnp.float32)
    got = gk.gate_shard_fused(torch.as_tensor(x32), torch.as_tensor(f32), n_valid, NFFT, HOP)
    assert got.dtype == torch.float32 and got.shape == want.shape
    snr = oracle.snr_db(want.astype(np.float64), got.numpy().astype(np.float64))
    assert snr >= 60.0, f"{snr:.2f} dB, {_flips(x_ext, floor, n_valid)} flipped bins"


def test_geometry_guards():
    x = torch.zeros(2, 4096 + D, dtype=torch.float64)
    floor = torch.ones(2, NFFT // 2 + 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="n_valid"):
        gk.gate_shard_fused(x, floor, 17, NFFT, HOP)
    with pytest.raises(ValueError, match="n_valid"):
        gk.gate_shard_fused(x, floor, np.int64(3), NFFT, HOP)
    with pytest.raises(ValueError, match="multiple of hop"):
        gk.gate_shard_ref(x[..., :-1], floor, 3, NFFT, HOP)

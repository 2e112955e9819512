"""The plain reference against the program's plain CPU routes at tiny
sizes (this test imports both; the reference imports nothing of the
program), and the work counts by hand."""

import math

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import chain as rchain
from portbench.reference import design_taps, dsp, out_len, run_chain, stream_latency
from portbench.roofline import bound_s, fft_flops

from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
from audiosignalprocess_tpu_torch.ops import fir as pfir
from audiosignalprocess_tpu_torch.ops import resample as pres
from audiosignalprocess_tpu_torch.pipeline import Chain


def _x(c, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.3 * n / 48000) & (t < 0.7 * n / 48000), 0.5 * np.sin(2 * np.pi * 440 * t), 0)
    return torch.as_tensor(x)


def _close(a, b, tol=1e-10):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    assert a.shape == b.shape
    assert float((a - b).norm() / b.norm()) < tol


@pytest.mark.parametrize("numtaps, cutoff", [(64, 0.3), (129, 0.01), (65, (0.2, 0.5))])
def test_design_fir_matches_the_program(numtaps, cutoff):
    assert np.array_equal(dsp.design_fir(numtaps, cutoff), pfir.design_fir(numtaps, cutoff))


@pytest.mark.parametrize("up, down", [(160, 147), (3, 2)])
def test_resample_filter_matches_the_program(up, down):
    assert np.array_equal(dsp.resample_filter(up, down), pres.resample_filter(up, down))


def test_fir():
    x, h = _x(3, 3000), dsp.design_fir(64, 0.3)
    _close(dsp.fir(x, h), pfir.fir_direct(x, h))


def test_resample():
    x, h = _x(2, 2940), dsp.resample_filter(160, 147)
    _close(dsp.resample(x, 160, 147, h),
           pres.resample_poly(x, 160, 147, h=h, zero_phase=False))


def test_noise_gate_and_floor():
    x = _x(2, 8192)
    y, floor = dsp.noise_gate(x, 1024, 256, 6.0, 60.0, 8, "hann")
    ref = noise_gate(x, 1024, 256, 6.0, 60.0, 8, 0.0, "hann")
    _close(y[..., : ref.shape[-1]], ref)
    assert not y[..., ref.shape[-1]:].any()
    # the floor handed back reproduces the gate
    _close(dsp.noise_gate(x, 1024, 256, 6.0, 60.0, 8, "hann", floor)[0], y)


def test_envelope():
    x, h = _x(2, 4000), dsp.design_fir(129, 0.01)
    _close(dsp.envelope(x, h), pfir.fir_direct(x.abs(), h) * (math.pi / 2))


@pytest.mark.parametrize("config, n", [("fir_gate_48k", 9000), ("config5_128ch", 9408)])
def test_chain_matches_full_flush(config, n):
    stages = [design_taps(s) for s in harness._json(harness.PKG / "configs" / f"{config}.json")["stages"]]
    x = _x(2, n)
    y, _ = run_chain(stages, x)
    _close(y, Chain.from_params(stages).full_flush(x))
    assert y.shape[-1] == out_len(stages, n)


@pytest.mark.parametrize("config, block", [("fir_gate_48k", 2048), ("config5_128ch", 2352)])
def test_a_stretch_under_the_streams_floor_matches_the_stream(config, block):
    """A block of a float64 stream is the reference's whole-file output of
    the stretch that ends with it, under the stream's floor."""
    stages = [design_taps(s) for s in harness._json(harness.PKG / "configs" / f"{config}.json")["stages"]]
    nb = 8
    x = _x(2, nb * block, seed=3)
    chain = Chain.from_params(stages)
    ys = chain.stream(x, block)
    ob, lat = out_len(stages, block), stream_latency(stages)
    assert lat == chain.latency and ob == chain.out_block(block)
    floors = rchain.chain_floors(stages, x[..., : 4 * block])
    k, s0 = 6, 3
    seg, _ = run_chain(stages, x[..., s0 * block : (k + 1) * block], floors)
    a = (k - s0) * ob - lat
    _close(seg[..., a : a + ob], ys[..., k * ob : (k + 1) * ob], 1e-9)


def _stage(config):
    return design_taps(harness._json(harness.PKG / "configs" / f"{config}.json")["stages"][0])


def test_work_fir_gate_48k_by_hand():
    work = harness.load_file(harness.PKG / "work" / "fir_gate_48k.py")
    nbytes, flops = work.call_work(_stage("fir_gate_48k"), 64, 480000)
    # each sample read and written once; 500 overlap-save blocks of 961
    # and 1872 gate frames a channel, each a 1024-point complex FFT's
    # worth (5 * 1024 * 10 = 51200 operations)
    assert nbytes == 8 * 64 * 480000 == 245_760_000
    assert flops == 64 * 51200 * (500 + 1872) == 7_772_569_600
    t, by = bound_s(nbytes, flops)
    assert by == "operations" and math.isclose(t, 7_772_569_600 / 67e12)
    # a block of 4096 at 512 channels: 4096/961 FIR blocks and 16 frames,
    # the carry (63 + 2*768 + 8*256 + 513 floats) read and written once
    nbytes, flops = work.block_work(_stage("fir_gate_48k"), 512, 4096)
    assert nbytes == 4 * 512 * (2 * 4096 + 2 * 4160)
    assert math.isclose(flops, 512 * 51200 * (4096 / 961 + 16))


def test_work_config5_by_hand():
    work = harness.load_file(harness.PKG / "work" / "config5_128ch.py")
    stage = _stage("config5_128ch")
    nbytes, flops = work.block_work(stage, 128, 9408)
    # 9408 in -> 10240 out; 21 resampler taps (3201 over 160 phases) and
    # 129 envelope taps an output, 2 operations a tap; 10240/961 FIR blocks
    # and 40 frames; carry 21 + 63 + 2*768 + 2048 + 513 + 128 = 4309
    assert fft_flops(1024) == 51200
    assert nbytes == 4 * 128 * (9408 + 10240 + 2 * 4309) == 14_472_192
    assert math.isclose(flops, 2 * (21 + 129) * 128 * 10240
                        + 128 * 51200 * (10240 / 961 + 40))
    nbytes, flops = work.call_work(stage, 128, 1321824)
    n_out = 1321824 * 160 // 147  # 1438720, exact
    assert n_out * 147 == 1321824 * 160
    frames = 1 + (n_out - 1024) // 256
    assert nbytes == 4 * 128 * (1321824 + n_out)
    assert math.isclose(flops, 2 * 150 * 128 * n_out
                        + 128 * 51200 * (math.ceil(n_out / 961) + frames))

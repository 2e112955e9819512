"""Twins of tests/integration/test_configs.py's TestConfig1, TestConfig2,
TestConfig5 and TestConfig5Ring for the port's config drivers
(``audiosignalprocess_tpu_torch.tools.run_config_{1,2,5}``) on the CPU:
the same seeded numpy inputs through the port and the JAX package (or
the oracle), with the reference tests' bars; a JAX carry resumed by the
port's ring; and the drivers' imports without jax."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import audiosignalprocess_tpu.pipeline as J
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.ops.fir import fir_direct as jax_fir_direct
from audiosignalprocess_tpu.ops.overlap_save import overlap_save as jax_overlap_save
from audiosignalprocess_tpu.ops.resample import resample_poly as jax_resample_poly
from audiosignalprocess_tpu_torch import pipeline as P
from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.tools import run_config_2, run_config_5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-6, atol=1e-7)  # the reference ring tests' float32 bar
CPU = "cpu"


def _tone_noise(channels, rate, seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = 0.01 * rng.standard_normal((channels, n))
    for c in range(channels):
        f = 220.0 * 2.0 ** (c % 12 / 12)
        x[c] += np.where((t > 0.25 * seconds) & (t < 0.7 * seconds),
                         0.5 * np.sin(2 * np.pi * f * t), 0.0)
    return x.astype(np.float32)


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


class TestConfig1:
    def test_wav_roundtrip_chain(self, tmp_path):
        """Mono 16 kHz -> 64-tap FIR overlap-save (the kernel's plain version
        on the CPU) -> WAV: the oracle >= 60 dB, and the JAX package's
        overlap-save on the same file."""
        x = _tone_noise(1, 16000, 2.0)
        h = design_fir(64, 0.25)
        inp, outp = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
        write_wav(inp, x, 16000, float_fmt=True)
        y, rate = read_wav(inp)
        out = overlap_save(torch.as_tensor(y), h, 1024, fused=True).numpy()
        write_wav(outp, out, rate, float_fmt=True)
        back, _ = read_wav(outp, dtype=np.float64)
        ref = oracle.overlap_save(x[0].astype(np.float64), h, 1024)
        assert back.shape == (1, ref.shape[0])
        assert oracle.snr_db(ref, back[0]) >= 60.0
        assert oracle.snr_db(np.asarray(jax_overlap_save(y, h, 1024)), out) >= 100.0

    def test_cli(self):
        """The driver runs on the CPU and asserts parity itself."""
        r = subprocess.run(
            [sys.executable, "-m", "audiosignalprocess_tpu_torch.tools.run_config_1",
             "--json", "--seconds", "1", "--device", CPU],
            capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
        assert r.returncode == 0, r.stderr[-2000:]
        assert '"parity": true' in r.stdout, r.stdout


class TestConfig2:
    def test_resample_bandpass(self):
        """Stereo 44.1 kHz -> zero-phase 160/147 -> 256-tap bandpass: the
        oracle >= 60 dB, and the JAX package's chain."""
        x = _tone_noise(2, 44100, 1.0)
        h = run_config_2.bandpass()
        out = run_config_2.chain(torch.as_tensor(x), h).numpy()
        ref = np.stack([
            oracle.fir_direct(oracle.resample_poly(x[c].astype(np.float64), 160, 147), h)
            for c in range(2)
        ])
        assert out.shape == ref.shape
        assert oracle.snr_db(ref, out) >= 60.0
        jout = np.asarray(jax_fir_direct(jax_resample_poly(x, 160, 147), h))
        assert oracle.snr_db(jout, out) >= 80.0


def _chain4(mod, fused=False):
    return mod.Chain([
        mod.ResampleStage(up=160, down=147, fused=fused),
        mod.FIRStage(h=oracle.design_fir(64, 0.3), nfft=1024, fused=fused),
        mod.GateStage(nfft=1024, hop=256, noise_frames=4, fused=fused),
        mod.EnvelopeStage(oracle.design_fir(129, 0.01), fused=fused),
    ])


class TestConfig5:
    def test_streaming_full_chain(self):
        """The four-stage chain streamed (the kernels' plain versions on the
        CPU) against its whole-file output, >= 80 dB, and against the JAX
        package's whole-file output on the same input."""
        block = 147 * 16
        x = _tone_noise(4, 44100, 1.0)[:, : block * 6]
        chain = _chain4(P, fused=True)
        lat = chain.build()
        full = chain.full(torch.as_tensor(x)).numpy()
        got = chain.stream(torch.as_tensor(x), block).numpy()[..., lat:]
        want = full[..., : got.shape[-1]]
        assert oracle.snr_db(want.astype(np.float64), got.astype(np.float64)) >= 80.0
        jc = _chain4(J)
        assert jc.build() == lat
        jfull = np.asarray(jc.full(x))[..., : got.shape[-1]]
        assert oracle.snr_db(jfull.astype(np.float64), got.astype(np.float64)) >= 80.0

    def test_driver_chains(self):
        """build_chain: the four stages with the kernels, or one composite
        stage, which with fused=False is the unfused composite."""
        four = run_config_5.build_chain()
        assert [type(s) for s in four.stages] == [P.ResampleStage, P.FIRStage, P.GateStage,
                                                  P.FIRStage]
        assert all(s.fused for s in four.stages)
        one = run_config_5.build_chain(composite=True)
        assert [type(s) for s in one.stages] == [P.ResFIRGateStage]
        assert one.stages[0].fused
        assert four.build() == one.build()
        assert run_config_5.BLOCK % 1176 == 0  # the composite's input quantum
        unfused = run_config_5.build_chain(fused=False, composite=True)
        assert [type(s) for s in unfused.stages] == [P.ResFIRGateStage]
        st = unfused.stages[0]
        assert not st.fused and not st._res.fused and not st._fg.fused
        assert unfused.build() == one.build()

    @pytest.mark.parametrize("mode", ("stream", "ring"))
    def test_composite_unfused_cli(self, mode):
        """run_config_5 --composite --no-fused on the CPU: the unfused
        composite streams (stream, or ring against the stream) and passes
        the driver's own check."""
        r = subprocess.run(
            [sys.executable, "-m", "audiosignalprocess_tpu_torch.tools.run_config_5",
             "--mode", mode, "--composite", "--no-fused", "--check", "--json", "--seconds",
             "0.5", "--device", CPU],
            capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
        assert r.returncode == 0, f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-2000:]}"
        recs = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith('{"config"')]
        assert len(recs) == 1 and recs[0]["parity"], r.stdout


def _chain3(mod):
    c = mod.Chain([
        mod.ResampleStage(up=160, down=147),
        mod.FIRStage(h=oracle.design_fir(64, 0.3), nfft=1024),
        mod.GateStage(nfft=1024, hop=256, noise_frames=4),
    ])
    c.build()
    return c


def _ring_wav(tmp_path, block, nblocks):
    x = _tone_noise(4, 44100, 1.0)[:, : block * nblocks]
    wav = str(tmp_path / "in.wav")
    write_wav(wav, x, 44100, float_fmt=True)
    return x, wav


def _stream(chain, x, block, drain=False):
    return chain.stream(torch.as_tensor(x), block, drain=drain).numpy()


class TestConfig5Ring:
    def test_ring_equals_stream_and_restart(self, tmp_path):
        """Ring streaming (native decode thread -> SPSC ring -> chain.step)
        == Chain.stream; restart from block 4 through the carry checkpoint
        reproduces the tail bit for bit."""
        block = 147 * 8
        x, wav = _ring_wav(tmp_path, block, 8)
        chain = _chain3(P)
        out, nb, _ = run_config_5.run_ring(chain, wav, block, 4, device=CPU)
        assert nb == 8
        ref = _stream(chain, x, block)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, **F32)
        ck = str(tmp_path / "carry.npz")
        out_a, _, _ = run_config_5.run_ring(chain, wav, block, 4, ckpt=(ck, 4), device=CPU)
        out_b, _, _ = run_config_5.run_ring(chain, wav, block, 4, resume=ck, device=CPU)
        np.testing.assert_array_equal(out_a[..., 4 * chain.out_block(block):], out_b)

    def test_ring_composite_one_kernel_chain(self, tmp_path):
        """The composite stage (resample -> FIR -> gate -> envelope, one
        step a block) behind the ring, two blocks a batch, == Chain.stream;
        its carry is the composition's with the envelope's tail."""
        block = 2 * 1176  # 2x the composite's input quantum at 160/147, hop 256
        x, wav = _ring_wav(tmp_path, block, 6)
        chain = P.Chain([P.ResFIRGateStage(
            up=160, down=147, h=design_fir(64, 0.3), nfft=1024, hop=256, noise_frames=4,
            env_h=design_fir(129, 0.05))])
        chain.build()
        st = chain.init_state((4,), block, torch.float32)
        assert isinstance(st[0], list) and tuple(st[0][1][2].shape) == (4, 128)
        stats = {}
        out, nb, dt = run_config_5.run_ring(chain, wav, block, 4, batch_blocks=2,
                                            device=CPU, stats=stats)
        assert nb == 6 and 0.0 <= stats["wait_s"] <= dt
        ref = _stream(chain, x, block)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, **F32)

    def test_ring_micro_batched(self, tmp_path):
        """batch_blocks=3: 8 blocks as 3 + 1 | 3 + 1 around a checkpoint at
        block 4 (3 + 3 + 1 + 1 without one) == Chain.stream, and the
        resumed tail is bit-identical."""
        block = 147 * 8
        x, wav = _ring_wav(tmp_path, block, 8)
        chain = _chain3(P)
        out, nb, _ = run_config_5.run_ring(chain, wav, block, 4, batch_blocks=3, device=CPU)
        assert nb == 8
        ref = _stream(chain, x, block)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, **F32)
        ck = str(tmp_path / "carry.npz")
        out_a, _, _ = run_config_5.run_ring(chain, wav, block, 4, ckpt=(ck, 4), batch_blocks=3,
                                            device=CPU)
        out_b, _, _ = run_config_5.run_ring(chain, wav, block, 4, resume=ck, batch_blocks=3,
                                            device=CPU)
        np.testing.assert_array_equal(out_a[..., 4 * chain.out_block(block):], out_b)

    def test_ring_drain_equals_stream_drain(self, tmp_path):
        """drain=True on a file that is no whole number of blocks: exactly
        Chain.stream(drain=True)'s length and samples, and the chain is
        disarmed afterwards."""
        block = 147 * 8
        x = _tone_noise(4, 44100, 1.0)[:, : block * 5 + 333]
        wav = str(tmp_path / "in.wav")
        write_wav(wav, x, 44100, float_fmt=True)
        chain = _chain3(P)
        out, nb, _ = run_config_5.run_ring(chain, wav, block, 4, drain=True, batch_blocks=2,
                                           device=CPU)
        ref = _stream(chain, x, block, drain=True)
        assert nb == chain.drain_blocks(x.shape[-1], block)
        assert out.shape == ref.shape == (4, chain.out_len(x.shape[-1]))
        np.testing.assert_allclose(out, ref, **F32)
        # disarmed: a later stream of the same chain is a fresh chain's
        np.testing.assert_array_equal(_stream(chain, x[:, : 4 * block], block),
                                      _stream(_chain3(P), x[:, : 4 * block], block))


def test_jax_carry_resumed_by_the_ports_ring(tmp_path):
    """The JAX driver's run_ring on its plain chain saves a float32
    checkpoint at block 4; the port's run_ring resumes from it and
    reproduces the JAX tail within the float32 bar."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    jax_run_config_5 = importlib.import_module("run_config_5")
    block = 147 * 8
    x, wav = _ring_wav(tmp_path, block, 8)
    ck = str(tmp_path / "jax_carry.npz")
    jchain, pchain = _chain3(J), _chain3(P)
    out_a, _, _ = jax_run_config_5.run_ring(jchain, wav, block, 4, ckpt=(ck, 4))
    out_b, nb, _ = run_config_5.run_ring(pchain, wav, block, 4, resume=ck, device=CPU)
    tail = out_a[..., 4 * jchain.out_block(block):]
    assert nb == 4 and out_b.shape == tail.shape
    np.testing.assert_allclose(out_b, tail, **F32)


def test_driver_modules_import_without_jax():
    """The port's drivers, harness and native binding import no jax."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import audiosignalprocess_tpu_torch.io.wav_native, "
            "audiosignalprocess_tpu_torch.tools.run_config_1, "
            "audiosignalprocess_tpu_torch.tools.run_config_2, "
            "audiosignalprocess_tpu_torch.tools.run_config_5, "
            "audiosignalprocess_tpu_torch.tools.scaling; "
            "assert not any(m == 'audiosignalprocess_tpu' or m.startswith("
            "'audiosignalprocess_tpu.') for m in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("mode", ("ring", "sharded"))
def test_config5_cli(mode):
    """The config-5 driver on the CPU with --check: the ring with a
    restart (bit-equal tail) and the sharded program under torchrun with
    two gloo ranks."""
    args = ["-m", "audiosignalprocess_tpu_torch.tools.run_config_5", "--mode", mode, "--check",
            "--json", "--seconds", "0.5", "--device", CPU]
    if mode == "ring":
        args += ["--demo-restart", "--ring-batch", "2"]
    else:
        args = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2", *args]
    r = subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-2000:]}"
    recs = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith('{"config"')]
    assert len(recs) == 1 and recs[0]["parity"], r.stdout
    if mode == "ring":
        assert recs[0]["restart_tail_bit_equal"] and recs[0]["bit_equal"]
    else:
        assert recs[0]["ranks"] == 2


def test_scaling_harness_functional():
    """tools/scaling.py on gloo CPU ranks, sizes 1, 2, 4 and 8: one row
    each, with samples/s and the efficiency against the first size (a
    functional check; the numbers are not a measurement)."""
    r = subprocess.run(
        [sys.executable, "-m", "audiosignalprocess_tpu_torch.tools.scaling", "--device", CPU,
         "--channels", "8", "--per-shard", str(147 * 32), "--json", "--iters", "2"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-2000:]}"
    rows = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert {1, 2, 4, 8} <= {row["devices"] for row in rows}, rows
    assert all(row["samples_per_s"] > 0 and row["backend"] == "gloo" for row in rows)
    assert rows[0]["scaling_eff"] == 1.0

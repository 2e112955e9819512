"""The port's resample -> FIR -> noise gate (-> envelope) chain, the
config-5 front end (44.1 -> 48 kHz at 160/147), vs the JAX package's.

Twins of tests/kernels/test_res_chain_kernel.py and of the ResFIRGateStage
cases of tests/unit/test_pipeline.py.  JAX runs as its own tests run it
(tests/conftest.py: CPU, x64, Pallas in interpret mode), so its
``resample_fir_gate_fused`` and its float32 ``ResFIRGateStage`` stream run
their Pallas kernels in interpret mode.  On the CPU the port's wrappers run
their plain versions and count no launch.

Tolerances: float64 port vs float64 JAX (kernel or composed path) and the
oracle rtol 1e-8, atol 1e-10; float32 >= 60 dB against the float64
oracle, >= 80 dB against the JAX float32 fused stream and against the
port's own full_flush.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu import pipeline as J
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.kernels import res_chain_kernel as jax_rc
from audiosignalprocess_tpu.utils import checkpoint as jax_checkpoint
from audiosignalprocess_tpu_torch import pipeline as P
from audiosignalprocess_tpu_torch.kernels import res_chain_kernel as rc
from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac
from audiosignalprocess_tpu_torch.utils import checkpoint

F64 = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture()
def rng():
    return np.random.default_rng(53)


def _mk(rng, c, n, fs=44100):
    """Tone burst in low noise (the JAX kernel tests' signal)."""
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.2 * n / fs) & (t < 0.7 * n / fs), np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


def _oracle_chain(x, up, down, h, **kw):
    return np.stack([oracle.noise_gate(oracle.fir_direct(
        oracle.resample_poly(r, up, down, zero_phase=False), h), **kw) for r in x])


def _snr(ref, got):
    return oracle.snr_db(np.asarray(ref, np.float64) + 1e-30,
                         np.asarray(got, np.float64) + 1e-30)


def _both(make_j, make_p):
    jc, pc = make_j(), make_p()
    assert jc.build() == pc.build()
    return jc, pc


# ---------------------------------------------------------------------------
# the whole-file kernel (resample_fir_gate_fused): its plain version here
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (name, up, down, channels, n, fs, taps, cutoff, release)
    ("vs_oracle_f64", 160, 147, 2, 147 * 160 * 2, 44100, 64, 0.3, 0.0),
    ("release_and_simple_ratio", 2, 1, 2, 16384, 24000, 96, 0.25, 0.7),
    ("long_fir", 160, 147, 1, 147 * 160 * 2, 44100, 384, 0.2, 0.0),
], ids=lambda c: c[0])
def test_resample_fir_gate_f64_vs_jax(rng, case):
    """float64: the JAX kernel (interpret mode) and the oracle chain."""
    _, up, down, c, n, fs, taps, cutoff, release = case
    x = _mk(rng, c, n, fs)
    h = oracle.design_fir(taps, cutoff)
    before = (rc.resample_fir_gate_fused.launches, resample_mac.launches)
    out = rc.resample_fir_gate_fused(torch.as_tensor(x), up, down, h, noise_frames=4,
                                     release=release).numpy()
    assert (rc.resample_fir_gate_fused.launches, resample_mac.launches) == before
    ref = np.asarray(jax_rc.resample_fir_gate_fused(x, up, down, h, noise_frames=4,
                                                    release=release))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **F64)
    np.testing.assert_allclose(out, _oracle_chain(x, up, down, h, noise_frames=4,
                                                  release=release), **F64)


def test_resample_fir_gate_f32_snr(rng):
    up, down = 160, 147
    x = _mk(rng, 2, 147 * 160 * 2).astype(np.float32)
    h = oracle.design_fir(64, 0.3)
    out = rc.resample_fir_gate_fused(torch.as_tensor(x), up, down, h, noise_frames=4)
    assert out.dtype == torch.float32
    ref = _oracle_chain(x.astype(np.float64), up, down, h, noise_frames=4)
    assert out.shape == ref.shape
    assert oracle.snr_db(ref, out.numpy().astype(np.float64)) >= 60.0
    jax_out = np.asarray(jax_rc.resample_fir_gate_fused(x, up, down, h, noise_frames=4))
    assert _snr(jax_out, out.numpy()) >= 80.0


def test_resample_fir_gate_any_length(rng):
    """Any raw length (the TPU kernel's row alignment of the resampled
    length does not apply): frames counted from ceil(n*up/down)."""
    x = _mk(rng, 1, 30001)
    h = oracle.design_fir(64, 0.3)
    out = rc.resample_fir_gate_fused(torch.as_tensor(x), 160, 147, h, noise_frames=4).numpy()
    n_res = -(-30001 * 160 // 147)
    assert out.shape == (1, 1024 + ((n_res - 1024) // 256) * 256)
    np.testing.assert_allclose(out, _oracle_chain(x, 160, 147, h, noise_frames=4), **F64)
    with pytest.raises(ValueError, match="no resampler"):
        rc.resample_fir_gate_fused(torch.as_tensor(x), 3, 3, h)


# ---------------------------------------------------------------------------
# ResFIRGateStage: whole file, streaming, drain, checkpoints
# ---------------------------------------------------------------------------

def _stage_kw(release=0.0, env=False):
    return dict(up=160, down=147, h=oracle.design_fir(64, 0.3), nfft=1024, hop=256,
                noise_frames=4, release=release,
                env_h=oracle.design_fir(129, 0.05) if env else None)


def test_step_geometry():
    """The block quantum: 1176 raw -> 1280 resampled at 160/147, 1024/256
    (the JAX package's too); the port's quantum divides the JAX one."""
    assert rc.res_step_geometry(160, 147, 1024, 256) == (1176, 1280)
    assert rc.res_step_geometry(320, 294, 1024, 256) == (1176, 1280)
    for up, down, nfft, hop in ((160, 147, 1024, 256), (2, 1, 1024, 256),
                                (3, 4, 512, 128), (147, 160, 1024, 256)):
        b_in, b_out = rc.res_step_geometry(up, down, nfft, hop)
        assert b_out * down == b_in * up and b_in % down == 0 and b_out % hop == 0
        assert jax_rc.res_step_geometry(up, down, nfft, hop)[0] % b_in == 0


@pytest.mark.parametrize("release,env", ((0.0, False), (0.6, False), (0.0, True)))
def test_f32_stream_vs_jax_fused(rng, release, env):
    """The port's float32 stream (plain steps on the CPU) against the JAX
    float32 stream (one Pallas kernel per block, interpret mode): >= 80 dB;
    latency and geometry equal."""
    kw = _stage_kw(release, env)
    jc, pc = _both(lambda: J.Chain([J.ResFIRGateStage(**kw)]),
                   lambda: P.Chain([P.ResFIRGateStage(**kw)]))
    b_in = 2 * 1176
    assert isinstance(jc.init_state((2,), b_in, jnp.float32)[0], dict)  # JAX's one-kernel path
    x = _mk(rng, 2, b_in * 4).astype(np.float32)
    before = rc.res_fir_gate_step_fused.launches
    y = pc.stream(torch.as_tensor(x), b_in).numpy()
    assert rc.res_fir_gate_step_fused.launches == before
    ref = np.asarray(jc.stream(jnp.asarray(x), b_in))
    assert y.shape == ref.shape == (2, 4 * 2560)
    assert _snr(ref, y) >= 80.0


@pytest.mark.parametrize("env", (False, True))
def test_f64_stream_and_full_vs_jax_composed(rng, env):
    """float64: stream and whole file equal the JAX composed path
    (ResampleStage -> FIRGateStage) to 1e-8; the stream's identity
    stream[L:] == full[: len - L] holds."""
    kw = _stage_kw(0.6, env)
    jc, pc = _both(lambda: J.Chain([J.ResFIRGateStage(**kw)]),
                   lambda: P.Chain([P.ResFIRGateStage(**kw)]))
    x = _mk(rng, 2, 2352 * 4)
    y = pc.stream(torch.as_tensor(x), 2352).numpy()
    np.testing.assert_allclose(y, np.asarray(jc.stream(jnp.asarray(x), 2352)), **F64)
    full = pc.full(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(full, np.asarray(jc.full(jnp.asarray(x))), **F64)
    lat = pc.latency
    np.testing.assert_allclose(y[:, lat:], full[:, : y.shape[-1] - lat], rtol=1e-8, atol=1e-8)


def test_f32_full_routes_through_fused_wrapper(rng):
    """float32 full() is resample_fir_gate_fused (its plain version here)
    padded to the rate-mapped length; float64 is the composition."""
    st = P.ResFIRGateStage(**_stage_kw())
    x = torch.as_tensor(_mk(rng, 2, 14700 + 11))
    y32 = st.full(x.float())
    ref32 = rc.resample_fir_gate_ref(x.float(), 160, 147, st.h, noise_frames=4)
    n_out = -(-x.shape[-1] * 160 // 147)
    assert y32.shape == (2, n_out) and y32.dtype == torch.float32
    assert torch.equal(y32[:, : ref32.shape[-1]], ref32)
    assert torch.count_nonzero(y32[:, ref32.shape[-1]:]) == 0
    composed = P.Chain([P.ResampleStage(160, 147), P.FIRGateStage(h=st.h, noise_frames=4)])
    assert torch.equal(st.full(x), composed.full(x))
    assert _snr(composed.full(x).numpy(), y32.numpy()) >= 60.0


@pytest.mark.parametrize("env", (False, True))
def test_drain_equals_full_flush(rng, env):
    """Twin of test_res_fir_gate_drain_fused: the drained stream of a
    length off the block is exactly out_len(n) samples, equal to
    full_flush (float32 >= 80 dB; float64 to 1e-8 and to the JAX drained
    composed stream)."""
    kw = dict(_stage_kw(0.0, False), env_h=oracle.design_fir(129, 2.0 * 50.0 / 48000)
              if env else None)
    x = 0.01 * rng.standard_normal((1, 14700 * 2 + 777))
    x[:, 8000:20000] += np.sin(2 * np.pi * 440.0 * np.arange(12000) / 44100.0)
    jc, pc = _both(lambda: J.Chain([J.ResFIRGateStage(**kw)]),
                   lambda: P.Chain([P.ResFIRGateStage(**kw)]))
    n = x.shape[-1]
    assert pc.drain_blocks(n, 2352) == jc.drain_blocks(n, 2352)
    x32 = torch.as_tensor(x.astype(np.float32))
    y32 = pc.stream(x32, 2352, drain=True)
    assert y32.shape == (1, pc.out_len(n))
    assert _snr(pc.full_flush(x32).numpy(), y32.numpy()) >= 80.0
    y64 = pc.stream(torch.as_tensor(x), 2352, drain=True).numpy()
    np.testing.assert_allclose(y64, pc.full_flush(torch.as_tensor(x)).numpy(), **F64)
    np.testing.assert_allclose(y64, np.asarray(jc.stream(jnp.asarray(x), 2352, drain=True)),
                               **F64)


def test_config5_chain_drain(rng):
    """Twin of test_config5_chain_drain: the chain stage by stage
    (ResampleStage -> FIRStage -> GateStage), float32, drained == full_flush
    >= 90 dB, and the same as the composite stage."""
    h = oracle.design_fir(64, 0.3)
    pc = P.Chain([P.ResampleStage(160, 147), P.FIRStage(h=h, nfft=1024),
                  P.GateStage(nfft=1024, hop=256, noise_frames=4)])
    jc = J.Chain([J.ResampleStage(160, 147), J.FIRStage(h=h, nfft=1024),
                  J.GateStage(nfft=1024, hop=256, noise_frames=4)])
    assert pc.build() == jc.build()
    x = torch.as_tensor(rng.standard_normal((2, 14700 * 2 + 777)).astype(np.float32))
    y = pc.stream(x, 2352, drain=True)
    assert y.shape == (2, pc.out_len(x.shape[-1])) == (2, jc.out_len(x.shape[-1]))
    assert _snr(pc.full_flush(x).numpy(), y.numpy()) >= 90.0
    comp = P.Chain([P.ResFIRGateStage(**_stage_kw())]).stream(x, 2352, drain=True)
    assert _snr(comp.numpy(), y.numpy()) >= 90.0


def test_block_quantum_error_names_input_block(rng):
    """A misaligned block is reported in the input domain (the user's
    block), not the resampled one."""
    c = P.Chain([P.ResFIRGateStage(up=160, down=147, h=oracle.design_fir(64, 0.3))])
    c.build()
    x = torch.as_tensor(rng.standard_normal((1, 4410 * 8)).astype(np.float32))
    with pytest.raises(ValueError, match="input quantum 1176"):
        c.stream(x, 4410)


@pytest.mark.parametrize("n,block", ((441000, 4704), (30000, 2352), (40000, 1176)))
def test_geometry_matches_jax(n, block):
    """Latency, out_len, out_block, tail_width and drain_blocks of the
    composite stage and of the stage-by-stage chain equal the JAX
    package's."""
    h, he = oracle.design_fir(64, 0.3), oracle.design_fir(129, 0.01)
    pairs = [
        (J.Chain([J.ResFIRGateStage(h=h, env_h=he)]), P.Chain([P.ResFIRGateStage(h=h, env_h=he)])),
        (J.Chain([J.ResampleStage(160, 147), J.FIRGateStage(h=h)]),
         P.Chain([P.ResampleStage(160, 147), P.FIRGateStage(h=h)])),
    ]
    for jc, pc in pairs:
        assert jc.build() == pc.build()
        assert (jc.out_len(n), jc.out_block(block), jc.tail_width(),
                jc.drain_blocks(n, block)) == (pc.out_len(n), pc.out_block(block),
                                               pc.tail_width(), pc.drain_blocks(n, block))
    assert pairs[0][1].out_len(441000) == 480000


def test_from_params_builds_resampler_stages(rng):
    """Chain.from_params from the JAX asdict of ResampleStage and
    ResFIRGateStage (fused and impl carried where the port's stage has
    them, input_latency dropped): the same stream as the JAX chain."""
    js = J.ResFIRGateStage(**_stage_kw(0.6, True))
    pc = P.Chain.from_params([dict(dataclasses.asdict(js), stage="ResFIRGateStage")])
    st = pc.stages[0]
    assert isinstance(st, P.ResFIRGateStage) and (st.up, st.down) == (160, 147)
    np.testing.assert_array_equal(st.h_res, js.h_res)
    np.testing.assert_array_equal(st.env_h, js.env_h)
    jc = J.Chain([js])
    assert pc.build() == jc.build()
    x = _mk(rng, 2, 2352 * 3)
    np.testing.assert_allclose(pc.stream(torch.as_tensor(x), 2352).numpy(),
                               np.asarray(jc.stream(jnp.asarray(x), 2352)), **F64)
    two = P.Chain.from_params([
        dict(dataclasses.asdict(J.ResampleStage(160, 147)), stage="ResampleStage"),
        dict(dataclasses.asdict(J.FIRGateStage(h=js.h, noise_frames=4)), stage="FIRGateStage")])
    assert [type(s) for s in two.stages] == [P.ResampleStage, P.FIRGateStage]
    assert two.build() == pc.build()


def test_jax_composed_carry_resumes_in_port(rng, tmp_path):
    """JAX streams 3 blocks through the composed (float64) ResFIRGateStage
    path and saves its carry with its utils/checkpoint; the port loads it
    and streams 3 more: the uninterrupted JAX stream, to 1e-8."""
    kw = _stage_kw(0.6, True)
    jc, pc = _both(lambda: J.Chain([J.ResFIRGateStage(**kw)]),
                   lambda: P.Chain([P.ResFIRGateStage(**kw)]))
    b = 2352
    x = _mk(rng, 2, 6 * b)
    st = jc.init_state((2,), b, jnp.float64)
    assert isinstance(st, list)  # the composed carry
    outs = []
    for k in range(3):
        st, y = jc.step(st, jnp.asarray(x[:, k * b : (k + 1) * b]))
        outs.append(np.asarray(y))
    jax_checkpoint.save_carry(str(tmp_path / "jax.npz"), st, block_index=3)
    pst, bk = checkpoint.load_carry(str(tmp_path / "jax.npz"),
                                    pc.init_state((2,), b, torch.float64))
    assert bk == 3
    for k in range(3, 6):
        pst, y = pc.step(pst, torch.as_tensor(x[:, k * b : (k + 1) * b]))
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=-1),
                               np.asarray(jc.stream(jnp.asarray(x), b)), **F64)


def test_port_carry_checkpoint_roundtrip(rng, tmp_path):
    """The float32 carry (the same layout for kernel and plain step)
    checkpoints and resumes bit-exactly."""
    chain = P.Chain([P.ResFIRGateStage(**_stage_kw(0.6, True))])
    b = 1176
    x = torch.as_tensor(_mk(rng, 2, 6 * b).astype(np.float32))
    st = chain.init_state((2,), b, torch.float32)
    outs = []
    for k in range(3):
        st, y = chain.step(st, x[:, k * b : (k + 1) * b])
        outs.append(y)
    checkpoint.save_carry(str(tmp_path / "ck"), st, block_index=3)
    st2, _ = checkpoint.load_carry(str(tmp_path / "ck"), chain.init_state((2,), b))
    for k in range(3, 6):
        st2, y = chain.step(st2, x[:, k * b : (k + 1) * b])
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=-1), chain.stream(x, b))


def test_path_d_on_cpu_vs_jax(rng):
    """Path D (ResampleStage(fused=True) -> FIRGateStage), float32 on the
    CPU: plain versions, no launch; the JAX float32 chain's stream
    (its resample_mac and FIR -> gate step kernels) >= 80 dB."""
    h = oracle.design_fir(64, 0.3)
    jc, pc = _both(
        lambda: J.Chain([J.ResampleStage(160, 147, fused=True),
                         J.FIRGateStage(h=h, noise_frames=4)]),
        lambda: P.Chain([P.ResampleStage(160, 147, fused=True),
                         P.FIRGateStage(h=h, noise_frames=4)]))
    x = _mk(rng, 2, 2352 * 3).astype(np.float32)
    before = resample_mac.launches
    y = pc.stream(torch.as_tensor(x), 2352).numpy()
    assert resample_mac.launches == before
    assert _snr(np.asarray(jc.stream(jnp.asarray(x), 2352)), y) >= 80.0

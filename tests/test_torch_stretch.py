"""The port's streaming phase vocoder (pipeline.StretchStage and
kernels/stretch_kernel) vs the JAX package's.

Twins of tests/unit/test_pipeline.py's TestStretchStage and its stretch
drain cases.  JAX runs as its own tests run it (tests/conftest.py: CPU,
x64, Pallas in interpret mode), so its float32 ``fused=True`` stream runs
the Pallas ``stretch_step_fused`` in interpret mode.  On the CPU the
port's ``stretch_step_fused`` runs its plain version ``stretch_step_ref``
and counts no launch.

Tolerances: float64 port vs float64 JAX rtol 1e-8, atol 1e-10; the
port's own stream == full >= 180 dB on interior samples (JAX's bar);
float32: the port's plain stream vs its full at the JAX package's figure
on the same input less 3 dB, and the port's step vs the JAX Pallas step
>= 65 dB (JAX's own bar for its kernel against its plain step).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu import pipeline as J
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.utils import checkpoint as jax_checkpoint
from audiosignalprocess_tpu_torch import pipeline as P
from audiosignalprocess_tpu_torch.kernels import fft_kernel, stretch_kernel
from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac
from audiosignalprocess_tpu_torch.kernels.stretch_kernel import (
    stretch_step_fused, stretch_step_ref,
)
from audiosignalprocess_tpu_torch.ops import fft
from audiosignalprocess_tpu_torch.utils import checkpoint

F64 = dict(rtol=1e-8, atol=1e-10)
RATES = ((3, 4), (4, 3), (1, 2), (147, 160))  # tests/unit/test_pipeline.py:298


@pytest.fixture()
def rng():
    return np.random.default_rng(97)


def _snr(ref, got):
    return oracle.snr_db(np.asarray(ref, np.float64) + 1e-30,
                         np.asarray(got, np.float64) + 1e-30)


def _both(make_j, make_p):
    jc, pc = make_j(), make_p()
    assert jc.build() == pc.build()
    return jc, pc


def _j(chain, x, block, drain=False):
    return np.asarray(chain.stream(jnp.asarray(x), block, drain=drain))


def _p(chain, x, block, drain=False):
    return chain.stream(torch.as_tensor(x), block, drain=drain).numpy()


def _block(p, hop=256):
    """The JAX tests' block: m = p * (16 // p + 1) frames."""
    return p * max(1, 16 // p + 1) * hop


def _interior_snr(chain, y, x):
    """The port's own contract: stream[L:] == full on interior samples
    (the whole-file tail ramp, the last 2048 samples, has no streaming
    counterpart)."""
    full = chain.full(torch.as_tensor(x)).numpy()
    got = y[..., chain.latency:]
    end = min(got.shape[-1], full.shape[-1]) - 2048
    return _snr(full[..., :end], got[..., :end])


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,q", RATES)
@pytest.mark.parametrize("after_gate", (False, True))
def test_geometry_matches_jax(p, q, after_gate):
    """n_skip, off, latency, the FIFO slots and fracs, block and length
    maps bit-equal to JAX, alone and after a GateStage(noise_frames=4)."""
    gate = lambda mod: [mod.GateStage(nfft=1024, hop=256, noise_frames=4)] if after_gate else []
    jc, pc = _both(lambda: J.Chain(gate(J) + [J.StretchStage(p=p, q=q)]),
                   lambda: P.Chain(gate(P) + [P.StretchStage(p=p, q=q)]))
    js, ps = jc.stages[-1], pc.stages[-1]
    assert (ps.n_skip, ps.off, ps.latency) == (js.n_skip, js.off, js.latency)
    for m in (p, 2 * p, p * (16 // p + 1), 4 * p):
        depth, slots, fracs = ps._slots(m)
        jdepth, jslots, jfracs = js._slots(m)
        assert depth == jdepth
        np.testing.assert_array_equal(slots, jslots)
        np.testing.assert_array_equal(fracs, jfracs)
    block = _block(p)
    n = 3 * block + 123
    assert pc.out_block(block) == jc.out_block(block)
    assert pc.out_len(n) == jc.out_len(n)
    assert pc.tail_width() == jc.tail_width()
    assert pc.drain_blocks(n, block) == jc.drain_blocks(n, block)
    ps.set_eof(n)
    js.set_eof(n)
    assert ps._eof_frames_out() == js._eof_frames_out()


def test_step_masks_cover_jax_positions():
    """The step's scalar positions (hit frame, emitted range, i0) equal
    the JAX step's per-frame masks over a drained stream."""
    m, mo, n_skip, off, nof = 16, 12, 3, 3, 40
    for blk in range(6):
        hit, lo, hi, i0, eof_out = stretch_kernel.stretch_step_masks(
            blk, m, mo, n_skip, off, 1024, 256, nof)
        phys = blk * m + np.arange(m)
        assert hit == (int(np.flatnonzero(phys == n_skip)[0]) if n_skip in phys else -1)
        i_glob = blk * mo + np.arange(mo) - off
        emit = (i_glob >= 0) & (i_glob < nof)
        np.testing.assert_array_equal(emit, (np.arange(mo) >= lo) & (np.arange(mo) < hi))
        assert i0 == blk * mo - off and eof_out == 1024 + (nof - 1) * 256


# ---------------------------------------------------------------------------
# float64: full, stream and drained stream vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,q", RATES)
def test_stream_and_full_vs_jax(rng, p, q):
    jc, pc = _both(lambda: J.Chain([J.StretchStage(p=p, q=q)]),
                   lambda: P.Chain([P.StretchStage(p=p, q=q)]))
    block = _block(p)
    x = rng.standard_normal((2, block * 4))
    y = _p(pc, x, block)
    np.testing.assert_allclose(y, _j(jc, x, block), **F64)
    np.testing.assert_allclose(pc.full(torch.as_tensor(x)).numpy(),
                               np.asarray(jc.full(jnp.asarray(x))), **F64)
    assert _interior_snr(pc, y, x) >= 180.0


@pytest.mark.parametrize("p,q", RATES)
def test_drain_vs_jax(rng, p, q):
    """stream(drain=True) == full_flush (exact out_len) and == JAX's."""
    jc, pc = _both(lambda: J.Chain([J.StretchStage(p=p, q=q)]),
                   lambda: P.Chain([P.StretchStage(p=p, q=q)]))
    block = _block(p)
    x = rng.standard_normal((2, block * 3 + 321))
    y = _p(pc, x, block, drain=True)
    ff = pc.full_flush(torch.as_tensor(x)).numpy()
    assert y.shape == ff.shape == (2, pc.out_len(x.shape[-1]))
    np.testing.assert_allclose(y, ff, **F64)
    np.testing.assert_allclose(y, _j(jc, x, block, drain=True), **F64)


@pytest.mark.parametrize("p,q", ((4, 3), (3, 4)))
def test_drain_float32_small_blocks(rng, p, q):
    """The JAX drain test's geometry (block = 256*p, m = p): the float32
    drained stream >= 90 dB against the port's full_flush and the JAX
    drained stream."""
    jc, pc = _both(lambda: J.Chain([J.StretchStage(p=p, q=q)]),
                   lambda: P.Chain([P.StretchStage(p=p, q=q, fused=True)]))
    x = rng.standard_normal((1, 12288 + 321)).astype(np.float32)
    y = _p(pc, x, 256 * p, drain=True)
    assert y.dtype == np.float32
    assert _snr(pc.full_flush(torch.as_tensor(x)).numpy(), y) >= 90.0
    assert _snr(_j(jc, x, 256 * p, drain=True), y) >= 90.0


def test_from_rate_exact_and_irrational(rng):
    assert (P.StretchStage.from_rate(0.75).p, P.StretchStage.from_rate(0.75).q) == (3, 4)
    rate = 2.0 ** (1.0 / 3.0)
    st = P.StretchStage.from_rate(rate, max_den=64, nfft=256, hop=64)
    js = J.StretchStage.from_rate(rate, max_den=64, nfft=256, hop=64)
    assert (st.p, st.q) == (js.p, js.q)
    assert st.q <= 64 and abs(st.p / st.q - rate) < 1.0 / (st.q * 64)
    jc, pc = _both(lambda: J.Chain([js]), lambda: P.Chain([st]))
    block = _block(st.p, 64)
    x = rng.standard_normal((2, block * 4))
    y = _p(pc, x, block)
    np.testing.assert_allclose(y, _j(jc, x, block), **F64)
    assert _interior_snr(pc, y, x) >= 180.0
    for bad in (0.0, -1.0, float("inf")):
        with pytest.raises(ValueError):
            P.StretchStage.from_rate(bad)


def test_after_gate_vs_jax(rng):
    kw = dict(nfft=1024, hop=256)
    jc, pc = _both(
        lambda: J.Chain([J.GateStage(noise_frames=4, **kw), J.StretchStage(p=4, q=3, **kw)]),
        lambda: P.Chain([P.GateStage(noise_frames=4, **kw), P.StretchStage(p=4, q=3, **kw)]))
    block = 4 * 16 * 256
    x = rng.standard_normal((2, block * 3))
    y = _p(pc, x, block)
    np.testing.assert_allclose(y, _j(jc, x, block), **F64)
    assert _interior_snr(pc, y, x) >= 180.0


def test_pitch_shift_chain_vs_jax(rng):
    """Stretch 1/2 then resample 1/2 (+1 octave), streamed."""
    jc, pc = _both(lambda: J.Chain([J.StretchStage(p=1, q=2), J.ResampleStage(up=1, down=2)]),
                   lambda: P.Chain([P.StretchStage(p=1, q=2), P.ResampleStage(up=1, down=2)]))
    x = rng.standard_normal((2, 2048 * 6))
    y = _p(pc, x, 2048)
    np.testing.assert_allclose(y, _j(jc, x, 2048), **F64)
    assert _interior_snr(pc, y, x) >= 180.0


def test_full_matches_time_stretch(rng):
    from audiosignalprocess_tpu_torch.effects.phase_vocoder import time_stretch

    x = torch.as_tensor(rng.standard_normal((2, 16384)))
    st = P.StretchStage(p=3, q=4)
    st.configure(0)
    y, ref = st.full(x).numpy(), time_stretch(x, 0.75).numpy()
    n = min(y.shape[-1], ref.shape[-1])
    np.testing.assert_allclose(y[..., :n], ref[..., :n], rtol=1e-7, atol=1e-8)


# ---------------------------------------------------------------------------
# float32: the plain step and the fused step's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,q", ((3, 4),))
def test_f32_plain_stream_vs_jax_f32(rng, p, q):
    """The float32 plain stream against JAX's float32 plain stream on the
    same input; its stream == full SNR within 3 dB of JAX's figure."""
    jc, pc = _both(lambda: J.Chain([J.StretchStage(p=p, q=q)]),
                   lambda: P.Chain([P.StretchStage(p=p, q=q)]))
    block = _block(p)
    x = rng.standard_normal((2, block * 4)).astype(np.float32)
    y, yj = _p(pc, x, block), _j(jc, x, block)
    assert y.dtype == np.float32
    assert _snr(yj, y) >= 70.0
    jfull = np.asarray(jc.full(jnp.asarray(x)))
    lat = jc.latency
    end = min(yj.shape[-1] - lat, jfull.shape[-1]) - 2048
    jax_figure = _snr(jfull[..., :end], yj[..., lat : lat + end])
    assert _interior_snr(pc, y, x) >= jax_figure - 3.0


def test_step_ref_vs_jax_pallas_step(rng):
    """The port's float32 step (stretch_step_fused's plain version on the
    CPU) against the JAX Pallas stretch_step_fused in interpret mode: one
    small case, 1 channel, 4 blocks at 4/3, >= 65 dB."""
    kw = dict(p=4, q=3, nfft=1024, hop=256, fused=True)
    jc, pc = _both(lambda: J.Chain([J.StretchStage(**kw)]), lambda: P.Chain([P.StretchStage(**kw)]))
    block = 8 * 256
    x = rng.standard_normal((1, 4 * block)).astype(np.float32)
    assert "gz0r" in jc.init_state((1,), block, jnp.float32)[0]  # the Pallas carry
    before = stretch_step_fused.launches
    y = _p(pc, x, block)
    assert stretch_step_fused.launches == before
    assert _snr(_j(jc, x, block), y) >= 65.0


@pytest.mark.parametrize("drain", (False, True))
def test_cpu_stream_launches_nothing(rng, drain):
    """A CPU float32 stream with fused=True runs stretch_step_ref and
    launches no kernel; it equals the plain step's stream exactly."""
    block = _block(4)
    x = torch.as_tensor(rng.standard_normal((2, 3 * block + (77 if drain else 0))),
                        dtype=torch.float32)
    counters = (stretch_step_fused, resample_mac, fft_kernel.rfft_stockham,
                fft_kernel.irfft_stockham)
    before = [k.launches for k in counters]
    fused = P.Chain([P.StretchStage(4, 3, fused=True), P.ResampleStage(3, 4, fused=True)])
    plain = P.Chain([P.StretchStage(4, 3), P.ResampleStage(3, 4)])
    y = fused.stream(x, block, drain=drain)
    assert [k.launches for k in counters] == before
    assert torch.equal(y, plain.stream(x, block, drain=drain))


def test_step_ref_is_pinned_to_torch(monkeypatch, rng):
    """With ``auto`` forced to the Stockham route and the Stockham
    wrappers made to fail, the plain step still runs: its FFTs are
    torch.fft's."""
    resolve = fft._resolve_impl
    monkeypatch.setattr(fft, "_resolve_impl",
                        lambda impl, x: "stockham" if impl == "auto" else resolve(impl, x))

    def fail(*a, **k):
        raise AssertionError("the plain step reached the Stockham kernels")

    for name in ("fft_stockham_lanes", "rfft_stockham", "irfft_stockham"):
        monkeypatch.setattr(fft_kernel, name, fail)
    st = P.StretchStage(4, 3)
    st.configure(0)
    x = torch.as_tensor(rng.standard_normal((2, 4096)), dtype=torch.float32)
    state = st.init_state((2,), 4096)
    stretch_step_ref(x, state, **st._step_kw())
    with pytest.raises(AssertionError, match="Stockham"):
        st.full(x)  # the control: the whole file takes the kernels


# ---------------------------------------------------------------------------
# stage parameters, errors and carries
# ---------------------------------------------------------------------------

def test_from_params_carries_a_jax_stretch_stage(rng):
    js = J.StretchStage(p=8, q=6, nfft=512, hop=128, fused=True)
    pc = P.Chain.from_params([dict(dataclasses.asdict(js), stage="StretchStage")])
    st = pc.stages[0]
    assert isinstance(st, P.StretchStage)
    assert (st.p, st.q, st.nfft, st.hop, st.fused, st.impl) == (4, 3, 512, 128, True, "auto")
    jc = J.Chain([J.StretchStage(p=4, q=3, nfft=512, hop=128)])
    assert pc.build() == jc.build()
    x = rng.standard_normal((2, 4 * 16 * 128))
    np.testing.assert_allclose(_p(pc, x.copy(), 16 * 128), _j(jc, x, 16 * 128), **F64)


@pytest.mark.parametrize("block", (256 * 3, 256 * 5, 1000))
def test_bad_block_raises(block):
    """m*q % p != 0 (or a block off the hop grid) raises, as in JAX."""
    pc = P.Chain([P.StretchStage(p=4, q=3)])
    jc = J.Chain([J.StretchStage(p=4, q=3)])
    x = np.zeros((1, block * 2))
    with pytest.raises(ValueError):
        _j(jc, x, block)
    with pytest.raises(ValueError, match="multiple of"):
        _p(pc, x, block)


def test_drain_short_input_raises():
    pc = P.Chain([P.StretchStage(p=4, q=3)])
    pc.build()
    with pytest.raises(ValueError, match="two complete analysis frames"):
        pc.stream(torch.zeros(1, 1200), 1024, drain=True)


def test_port_carry_leaves_in_jax_order(rng):
    """The port's carry flattens to the JAX plain-path carry's leaves:
    same count, shapes and values after one block."""
    import jax

    jc, pc = _both(lambda: J.Chain([J.StretchStage(p=4, q=3)]),
                   lambda: P.Chain([P.StretchStage(p=4, q=3)]))
    block = _block(4)
    x = rng.standard_normal((2, block))
    js, _ = jc.step(jc.init_state((2,), block, jnp.float64), jnp.asarray(x))
    ps, _ = pc.step(pc.init_state((2,), block, torch.float64), torch.as_tensor(x))
    jl = jax.tree_util.tree_leaves(js)
    pl = checkpoint._leaves(ps)
    assert len(jl) == len(pl) == 9
    for a, b in zip(jl, pl):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert np.shape(a) == b.shape
        np.testing.assert_allclose(b, np.asarray(a), **F64)


def test_port_carry_checkpoint_roundtrip(rng, tmp_path):
    """Stream halfway, checkpoint the carry, resume: the same output."""
    chain = P.Chain([P.StretchStage(p=3, q=4)])
    block = _block(3)
    x = torch.as_tensor(rng.standard_normal((2, 6 * block)))
    states = chain.init_state((2,), block, torch.float64)
    outs = []
    for k in range(3):
        states, y = chain.step(states, x[:, k * block : (k + 1) * block])
        outs.append(y)
    checkpoint.save_carry(str(tmp_path / "ck"), states, block_index=3)
    states2, bk = checkpoint.load_carry(str(tmp_path / "ck"),
                                        chain.init_state((2,), block, torch.float64))
    assert bk == 3 and states2[0]["blk"] == 3
    for k in range(3, 6):
        states2, y = chain.step(states2, x[:, k * block : (k + 1) * block])
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=-1), chain.stream(x, block))


def test_jax_plain_carry_resumes_in_port(rng, tmp_path):
    """JAX streams 3 blocks through its plain (float64) step and saves its
    carry (``blk`` an int32 array); the port loads it and streams 3 more:
    the uninterrupted JAX stream, within the float64 tolerance."""
    jc, pc = _both(lambda: J.Chain([J.StretchStage(p=4, q=3)]),
                   lambda: P.Chain([P.StretchStage(p=4, q=3)]))
    block = _block(4)
    x = rng.standard_normal((2, 6 * block))
    st = jc.init_state((2,), block, jnp.float64)
    outs = []
    for k in range(3):
        st, y = jc.step(st, jnp.asarray(x[:, k * block : (k + 1) * block]))
        outs.append(np.asarray(y))
    assert np.asarray(st[0]["blk"]).dtype == np.int32
    jax_checkpoint.save_carry(str(tmp_path / "jax.npz"), st, block_index=3)
    pst, bk = checkpoint.load_carry(str(tmp_path / "jax.npz"),
                                    pc.init_state((2,), block, torch.float64))
    assert bk == 3 and pst[0]["blk"] == 3 and isinstance(pst[0]["blk"], int)
    for k in range(3, 6):
        pst, y = pc.step(pst, torch.as_tensor(x[:, k * block : (k + 1) * block]))
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=-1), _j(jc, x, block), **F64)


def test_vocoder_imports_no_jax_and_no_nvcc():
    """The vocoder's modules import without jax and without nvcc, and the
    kernel's counter starts at 0."""
    code = ("import sys; from audiosignalprocess_tpu_torch.kernels import stretch_kernel as sk; "
            "from audiosignalprocess_tpu_torch.effects import phase_vocoder; "
            "from audiosignalprocess_tpu_torch import api, pipeline, kernels; "
            "assert sk.stretch_step_fused.launches == 0; "
            "assert kernels.stretch_step_fused is sk.stretch_step_fused; "
            "assert pipeline.STAGES['StretchStage'] is pipeline.StretchStage; "
            "assert 'jax' not in sys.modules")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, env={**os.environ, "PATH": os.path.dirname(sys.executable),
                                          "CUDA_HOME": os.devnull})
    assert proc.returncode == 0, proc.stderr

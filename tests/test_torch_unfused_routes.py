"""The unfused routes of the port's stages against the JAX package's.

``FIRGateStage(fused=False)`` and ``ResFIRGateStage(fused=False)`` run
their components (``FIRStage`` -> ``GateStage`` (-> the direct-form
envelope), after ``ResampleStage``) unfused with the stage's ``impl``,
and the unfused streaming steps of ``GateStage`` and ``StretchStage`` hand
their ``impl`` to ``ops.fft``, as the JAX stages do.  JAX runs as its own
tests run it (tests/conftest.py: CPU, x64, Pallas in interpret mode); its
``auto`` resolves to its plain matmul transform there, the port's to
torch.fft.

Tolerances: float64 rtol 1e-8, atol 1e-10; float32 >= 60 dB against the
JAX float32 stage on three seeds, the gate decisions that float32
rounding flips counted (the gate's hard thresholds, ROADMAP Queue 3 "by
design"); a sharded chain against its ``full`` at the existing sharded
twins' bars (float64 rtol 1e-7, atol 1e-9; float32 >= 80 dB).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers
from audiosignalprocess_tpu import pipeline as J
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.utils import checkpoint as jax_checkpoint
from audiosignalprocess_tpu_torch import pipeline as P
from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.stft import stft
from audiosignalprocess_tpu_torch.parallel import spawn_local
from audiosignalprocess_tpu_torch.parallel.sharded import _components
from audiosignalprocess_tpu_torch.utils import checkpoint

F64 = dict(rtol=1e-8, atol=1e-10)
H = oracle.design_fir(64, 0.3)
HE = oracle.design_fir(129, 0.05)
GATE = dict(nfft=1024, hop=256, noise_frames=4)
SEEDS = (1, 2, 3)
STAGES = {  # name: (stage kwargs, block, sample rate)
    "fir_gate": (dict(h=H, **GATE), 2048, 48000),
    "fir_gate_env": (dict(h=H, env_h=HE, release=0.6, **GATE), 2048, 48000),
    "res_fir_gate": (dict(up=160, down=147, h=H, env_h=HE, **GATE), 2352, 44100),
}


def _burst(seed, c, n, fs):
    """Tone burst in low noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    return 0.01 * rng.standard_normal((c, n)) + np.where(
        (t > 0.25 * n / fs) & (t < 0.7 * n / fs), np.sin(2 * np.pi * 440.0 * t), 0.0)


def _snr(ref, got):
    return oracle.snr_db(np.asarray(ref, np.float64) + 1e-30,
                         np.asarray(got, np.float64) + 1e-30)


def _flips(x64, name):
    """Gate decisions that float32 rounding flips on the gate's input (its
    float32 stft against float64)."""
    kw = STAGES[name][0]
    g_in = torch.as_tensor(x64)
    if "up" in kw:
        g_in = P.ResampleStage(kw["up"], kw["down"]).full(g_in)
    g_in = P.FIRStage(h=H, nfft=GATE["nfft"]).full(g_in)
    dec = []
    for dt in (torch.float32, torch.float64):
        mag = stft(g_in.to(dt), GATE["nfft"], GATE["hop"]).abs()
        floor = mag[..., : GATE["noise_frames"], :].mean(dim=-2, keepdim=True)
        dec.append(mag > floor * 10.0 ** (6.0 / 20.0))
    return int((dec[0] != dec[1]).sum())


def _chains(name, **extra):
    """The JAX and the port's chain of one unfused composite, built."""
    kw, _, _ = STAGES[name]
    cls = "ResFIRGateStage" if "up" in kw else "FIRGateStage"
    jc = J.Chain([getattr(J, cls)(fused=False, **kw, **extra)])
    pc = P.Chain([getattr(P, cls)(fused=False, **kw, **extra)])
    assert jc.build() == pc.build()
    return jc, pc


def _run(chain, x, mode, block):
    if mode == "full":  # the JAX chain's whole file jitted: one compile
        return jax.jit(chain.full)(x) if isinstance(chain, J.Chain) else chain.full(x)
    return chain.stream(x, block, drain=mode == "drain")


# ---------------------------------------------------------------------------
# the unfused composites, whole file and stream, against the JAX stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ("f64", "f32"))
@pytest.mark.parametrize("mode", ("full", "stream", "drain"))
@pytest.mark.parametrize("name", tuple(STAGES))
def test_unfused_composite_vs_jax(name, mode, prec):
    """FIRGateStage(fused=False) (with and without the envelope) and
    ResFIRGateStage(fused=False) at 160/147: full, stream and
    stream(drain=True) against the JAX stage with fused=False on the same
    input; float64 to 1e-8, float32 >= 60 dB on each of three seeds (two
    channels each, one call) with flips counted."""
    _, block, fs = STAGES[name]
    n = 5 * block + (333 if mode == "drain" else 0)
    seeds = (7,) if prec == "f64" else SEEDS
    x64 = np.concatenate([_burst(seed, 2, n, fs) for seed in seeds])
    x = x64 if prec == "f64" else x64.astype(np.float32)
    jc, pc = _chains(name)
    y = _run(pc, torch.as_tensor(x), mode, block).numpy()
    ref = np.asarray(_run(jc, jnp.asarray(x), mode, block))
    assert y.shape == ref.shape and y.dtype == x.dtype
    if prec == "f64":
        np.testing.assert_allclose(y, ref, **F64)
        return
    for k, seed in enumerate(seeds):
        c = slice(2 * k, 2 * k + 2)
        snr = _snr(ref[c], y[c])
        assert snr >= 60.0, f"seed {seed}: {snr:.2f} dB, {_flips(x64[c], name)} flipped bins"


def test_unfused_composite_routes_through_components(monkeypatch):
    """With fused=False neither the whole-file nor the step kernel wrapper
    is called on float32, and the carry is the components' list."""
    from audiosignalprocess_tpu_torch import pipeline
    from audiosignalprocess_tpu_torch.kernels import fir_kernel, os_kernel, resample_kernel

    def fail(*a, **k):
        raise AssertionError("the unfused route reached a fused kernel")

    for name in ("fir_noise_gate_fused", "fir_gate_step_fused", "resample_fir_gate_fused",
                 "res_fir_gate_step_fused", "gate_step_fused"):
        monkeypatch.setattr(pipeline, name, fail)
    for mod, name in ((os_kernel, "overlap_save_fused"), (fir_kernel, "fir_mac"),
                      (resample_kernel, "resample_mac")):
        monkeypatch.setattr(mod, name, fail)
    for name in STAGES:
        _, pc = _chains(name)
        st = pc.stages[0]
        fg = st._fg if isinstance(st, P.ResFIRGateStage) else st
        assert not (fg._fir.fused or fg._gate.fused or (fg._env is not None and fg._env.fused))
        _, block, fs = STAGES[name]
        x = torch.as_tensor(_burst(5, 2, 3 * block, fs).astype(np.float32))
        pc.full(x)
        carry = pc.init_state((2,), block, torch.float32)
        carry, _ = pc.step(carry, x[:, :block])
        assert isinstance(carry[0], list)


# ---------------------------------------------------------------------------
# the unfused steps hand their impl to ops.fft
# ---------------------------------------------------------------------------

IMPL_NAMES = tuple(i for i in fft_ops.IMPLS) + ("pallas_r2", "pallas_sk", "xla")


def _spy(monkeypatch):
    """Record the impl of every ops.fft.rfft / irfft call."""
    seen = []
    rfft, irfft = fft_ops.rfft, fft_ops.irfft

    def spy_rfft(x, impl=fft_ops.DEFAULT_IMPL):
        seen.append(("rfft", impl))
        return rfft(x, impl=impl)

    def spy_irfft(spec, n, impl=fft_ops.DEFAULT_IMPL):
        seen.append(("irfft", impl))
        return irfft(spec, n, impl=impl)

    monkeypatch.setattr(fft_ops, "rfft", spy_rfft)
    monkeypatch.setattr(fft_ops, "irfft", spy_irfft)
    return seen


@pytest.mark.parametrize("impl", IMPL_NAMES)
@pytest.mark.parametrize("stage", ("gate", "stretch"))
def test_unfused_step_hands_impl_to_fft(monkeypatch, stage, impl):
    """GateStage(fused=False, impl).step and StretchStage(fused=False,
    impl).step: one rfft and one irfft a block, each with the stage's impl
    (the port's names and the JAX names alike); the stream agrees with the
    torch.fft route to float64 rounding."""
    kw = dict(nfft=256, hop=64)
    if stage == "gate":
        make = lambda i: P.Chain([P.GateStage(noise_frames=4, impl=i, **kw)])
        block = 512
    else:
        make = lambda i: P.Chain([P.StretchStage(4, 3, impl=i, **kw)])
        block = 16 * 64
    x = torch.as_tensor(_burst(11, 2, 4 * block, 48000))
    ref = make("torch").stream(x, block).numpy()
    seen = _spy(monkeypatch)
    y = make(impl).stream(x, block).numpy()
    assert seen == [("rfft", impl), ("irfft", impl)] * 4
    np.testing.assert_allclose(y, ref, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("stage", ("gate", "stretch"))
def test_unfused_step_radix2_vs_jax(stage):
    """The unfused step at impl="radix2" against the JAX stage at
    impl="radix2" (plain jnp), float64, drained."""
    kw = dict(nfft=256, hop=64, impl="radix2")
    if stage == "gate":
        jc = J.Chain([J.GateStage(noise_frames=4, release=0.5, **kw)])
        pc = P.Chain([P.GateStage(noise_frames=4, release=0.5, **kw)])
        block = 512
    else:
        jc, pc = J.Chain([J.StretchStage(4, 3, **kw)]), P.Chain([P.StretchStage(4, 3, **kw)])
        block = 16 * 64
    assert jc.build() == pc.build()
    x = _burst(12, 2, 5 * block + 99, 48000)
    y = pc.stream(torch.as_tensor(x), block, drain=True).numpy()
    np.testing.assert_allclose(y, np.asarray(jc.stream(jnp.asarray(x), block, drain=True)),
                               **F64)


# ---------------------------------------------------------------------------
# parameters and carries from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,impl", [("fir_gate_env", "pallas_r2"), ("res_fir_gate", "auto")])
def test_from_params_keeps_fused_and_impl(name, impl):
    """Chain.from_params of a JAX FIRGateStage(fused=False,
    impl="pallas_r2") and a JAX ResFIRGateStage(fused=False): the port's
    stage keeps fused and impl (a JAX impl name resolves in ops.fft), and
    streams as the JAX chain does (float64)."""
    kw, block, fs = STAGES[name]
    cls = "ResFIRGateStage" if "up" in kw else "FIRGateStage"
    js = getattr(J, cls)(fused=False, impl=impl, **kw)
    pc = P.Chain.from_params([dict(dataclasses.asdict(js), stage=cls)])
    st = pc.stages[0]
    assert isinstance(st, getattr(P, cls)) and st.fused is False and st.impl == impl
    fg = st._fg if cls == "ResFIRGateStage" else st
    assert (fg._fir.impl, fg._gate.impl, fg._fir.fused, fg._gate.fused) == (impl, impl, False,
                                                                           False)
    jc = J.Chain([js])
    assert pc.build() == jc.build()
    x = _burst(13, 2, 3 * block, fs)
    np.testing.assert_allclose(pc.stream(torch.as_tensor(x), block).numpy(),
                               np.asarray(jc.stream(jnp.asarray(x), block)), **F64)


def test_jax_unfused_f32_carry_resumes_in_port(tmp_path):
    """JAX steps 3 float32 blocks through its unfused ResFIRGateStage (with
    the envelope) and saves the carry with its utils/checkpoint; the
    port's fused=False stage loads it and steps 3 more: the JAX tail to
    the float32 bar."""
    _, block, fs = STAGES["res_fir_gate"]
    jc, pc = _chains("res_fir_gate")
    x = _burst(14, 2, 6 * block, fs).astype(np.float32)
    blocks = [x[:, k * block : (k + 1) * block] for k in range(6)]
    step = jax.jit(jc.step)
    st = jc.init_state((2,), block, jnp.float32)
    want = []
    for k in range(6):
        st, y = step(st, jnp.asarray(blocks[k]))
        if k == 2:
            jax_checkpoint.save_carry(str(tmp_path / "jax.npz"), st, block_index=3)
        want.append(np.asarray(y))
    pst, bk = checkpoint.load_carry(str(tmp_path / "jax.npz"),
                                    pc.init_state((2,), block, torch.float32))
    assert bk == 3
    tail = []
    for k in range(3, 6):
        pst, y = pc.step(pst, torch.as_tensor(blocks[k]))
        tail.append(y.numpy())
    snr = _snr(np.concatenate(want[3:], axis=-1), np.concatenate(tail, axis=-1))
    assert snr >= 60.0, f"{snr:.2f} dB, {_flips(x.astype(np.float64), 'res_fir_gate')} flips"


# ---------------------------------------------------------------------------
# the sharded chain follows fused and impl
# ---------------------------------------------------------------------------

N_SHARD = 2 * 147 * 128  # two time shards of 147 x 128 raw samples, 80 hops resampled


def test_sharded_components_follow_fused():
    """parallel.sharded's components of an unfused composite are unfused
    and carry its impl; the folded envelope is direct form."""
    chain = P.Chain([P.ResFIRGateStage(fused=False, impl="fourstep", h=H, env_h=HE, **GATE)])
    comps = _components(chain)
    assert [type(s) for s in comps] == [P.ResampleStage, P.FIRStage, P.GateStage, P.FIRStage]
    assert not any(s.fused for s in comps)
    assert (comps[1].impl, comps[2].impl, comps[3].nfft, comps[3].pre) == (
        "fourstep", "fourstep", None, "abs")


@pytest.fixture(scope="module")
def two_ranks():
    """(inputs, outputs) of one 2-rank gloo world on a (1, 2) mesh."""
    x64 = _burst(15, 2, N_SHARD, 44100)
    chain = P.Chain([P.ResFIRGateStage(fused=False, h=H, env_h=HE, **GATE)])
    cases = [(name, "chain", (1, 2), dict(chain=chain), x)
             for name, x in (("f64", x64), ("f32", x64.astype(np.float32)))]
    out = spawn_local(torch_dist_workers.run_cases, 2, args=(cases,), device="cpu",
                      timeout_s=240.0)[0]
    return dict(f64=x64, f32=x64.astype(np.float32)), out


@pytest.mark.parametrize("prec", ("f64", "f32"))
def test_sharded_unfused_composite_matches_full(two_ranks, prec):
    """Chain([ResFIRGateStage(fused=False, env_h)]) through
    parallel.sharded_chain on 2 gloo ranks against chain.full: float64 to
    rtol 1e-7, atol 1e-9; float32 >= 80 dB."""
    x, out = two_ranks
    chain = P.Chain([P.ResFIRGateStage(fused=False, h=H, env_h=HE, **GATE)])
    chain.build()
    want = chain.full(torch.as_tensor(x[prec])).numpy()
    assert out[prec].shape == want.shape
    if prec == "f64":
        np.testing.assert_allclose(out[prec], want, rtol=1e-7, atol=1e-9)
    else:
        assert _snr(want, out[prec]) >= 80.0

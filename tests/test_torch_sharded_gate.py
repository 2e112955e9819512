"""Twins of tests/dist/test_sharded.py's fused gate, release and chain tests
for the port's ``parallel`` on a real 8-process gloo world.

One world (``parallel.spawn_local``, 8 ranks) runs every case of this
file; this process computes the JAX package's sharded outputs on the same
inputs (8 virtual CPU devices, Pallas in interpret mode).  On the
CPU ``gate_shard_fused`` runs its plain version ``gate_shard_ref``, the
same arithmetic the kernel does on the card.

Bars: float64 rtol 1e-7 / atol 1e-9 against the port's unsharded output
and the JAX sharded output (rtol 1e-8 with release, as the JAX test);
float32 bit-equal on a channel-only mesh (each rank runs the whole-file
gate on whole signals), >= 120 dB against the whole-file gate where time
is sharded (the spill exchange re-associates the overlap-add), >= 80 dB
for the composite chain (the JAX test's bar) and >= 60 dB against the
oracle and against the JAX float32 outputs: the JAX fused gate takes its
floor from a matmul FFT and its spectra from the TPU-layout Pallas
transforms, so a few borderline bins decide differently (the gate's hard
thresholds, ROADMAP Queue 3 "by design").
"""

import numpy as np
import pytest
import torch

import torch_dist_workers
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.parallel import mesh as jax_mesh
from audiosignalprocess_tpu.parallel import sharded as jax_sharded
from audiosignalprocess_tpu import pipeline as jax_pipeline
from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
from audiosignalprocess_tpu_torch.kernels.gate_kernel import noise_gate_fused
from audiosignalprocess_tpu_torch.parallel import spawn_local
from audiosignalprocess_tpu_torch.pipeline import (
    Chain, EnvelopeStage, FIRStage, GateStage, ResampleStage, ResFIRGateStage,
)

FUSED_MESHES = ((1, 8), (2, 4), (4, 2), (8, 1))
H = oracle.design_fir(64, 0.3)
HE = oracle.design_fir(129, 0.05)
N_CHAIN = 147 * 256  # per-shard n/4 a multiple of 147; resampled (40 hops), of hop
GATE4 = dict(nfft=1024, hop=256, noise_frames=4)


def _snr(ref, out):
    return oracle.snr_db(np.asarray(ref, np.float64) + 1e-30,
                         np.asarray(out, np.float64) + 1e-30)


def _inputs():
    rng = np.random.default_rng(23)
    n = 8192 * 4
    t = np.arange(n) / 48000
    fused = (0.01 * rng.standard_normal((8, n))).astype(np.float32)
    fused += np.where((t > 0.2) & (t < 0.5), np.sin(2 * np.pi * 440.0 * t), 0.0).astype(np.float32)
    short = (0.01 * rng.standard_normal((8, 16384))).astype(np.float32)
    short[:, 4000:9000] += np.sin(2 * np.pi * 440.0 * np.arange(5000) / 48000).astype(np.float32)
    release = rng.standard_normal((8, 8 * 4096))
    release[:, : 3 * 4096] *= 0.01
    comp32 = (0.01 * rng.standard_normal((8, N_CHAIN))).astype(np.float32)
    comp32[:, N_CHAIN // 4 : N_CHAIN // 2] += np.sin(
        2 * np.pi * 440 * np.arange(N_CHAIN // 2 - N_CHAIN // 4) / 44100).astype(np.float32)
    return dict(fused=fused, short=short, release=release,
                chain=rng.standard_normal((8, N_CHAIN)), comp32=comp32)


def _port_chains():
    return dict(
        chain=Chain([ResampleStage(up=160, down=147), FIRStage(h=H, nfft=1024),
                     GateStage(**GATE4)]),
        comp=Chain([ResFIRGateStage(up=160, down=147, h=H, **GATE4)]),
        comp_env=Chain([ResFIRGateStage(up=160, down=147, h=H, env_h=HE, **GATE4)]))


def _cases(x):
    fused = dict(noise_frames=8, fused=True)
    chains = _port_chains()
    cases = [(f"fused {m}", "gate", m, fused, x["fused"]) for m in FUSED_MESHES]
    cases += [("short fused", "gate", (1, 8), fused, x["short"]),
              ("short plain", "gate", (1, 8), dict(noise_frames=8), x["short"])]
    cases += [(f"release {m}", "gate", m, dict(noise_frames=8, release=0.8), x["release"])
              for m in ((1, 8), (2, 4))]
    cases += [("chain", "chain", (2, 4), dict(chain=chains["chain"]), x["chain"]),
              ("comp", "chain", (2, 4), dict(chain=chains["comp"]), x["chain"]),
              ("comp_env", "chain", (2, 4), dict(chain=chains["comp_env"]), x["chain"]),
              ("comp32", "chain", (2, 4), dict(chain=chains["comp"]), x["comp32"])]
    return cases


def _jax(fn_of_mesh, x, ch, tm):
    mesh = jax_mesh.make_mesh(channel=ch, time=tm)
    return np.asarray(fn_of_mesh(mesh)(jax_mesh.shard_audio(x, mesh)))


def _jax_outputs(x):
    out = {f"fused {m}": _jax(lambda mesh: jax_sharded.sharded_noise_gate(
        mesh, noise_frames=8, fused=True), x["fused"], *m) for m in FUSED_MESHES}
    out["short fused"] = _jax(lambda mesh: jax_sharded.sharded_noise_gate(
        mesh, noise_frames=8, fused=True), x["short"], 1, 8)
    out.update({f"release {m}": _jax(lambda mesh: jax_sharded.sharded_noise_gate(
        mesh, nfft=1024, hop=256, noise_frames=8, release=0.8), x["release"], *m)
        for m in ((1, 8), (2, 4))})
    jp = jax_pipeline
    chains = dict(
        chain=jp.Chain([jp.ResampleStage(up=160, down=147), jp.FIRStage(h=H, nfft=1024),
                        jp.GateStage(**GATE4)]),
        comp_env=jp.Chain([jp.ResFIRGateStage(up=160, down=147, h=H, env_h=HE, **GATE4)]))
    for name, chain in chains.items():
        chain.build()
        out[name] = _jax(lambda mesh: jax_sharded.sharded_chain(mesh, chain), x["chain"], 2, 4)
    comp32 = jp.Chain([jp.ResFIRGateStage(up=160, down=147, h=H, fused=True, **GATE4)])
    comp32.build()
    out["comp32"] = _jax(lambda mesh: jax_sharded.sharded_chain(mesh, comp32), x["comp32"], 2, 4)
    return out


@pytest.fixture(scope="module")
def world():
    """(inputs, port outputs, JAX outputs): one 8-rank world for every case,
    then the JAX outputs in this process."""
    x = _inputs()
    port = spawn_local(torch_dist_workers.run_cases, 8, args=(_cases(x),), device="cpu",
                       timeout_s=240.0)[0]
    return x, port, _jax_outputs(x)


class TestFusedSharded:
    @pytest.mark.parametrize("ch,tm", FUSED_MESHES)
    def test_gate_fused_time_sharded(self, world, ch, tm):
        """gate_shard_fused per time shard with the floor broadcast, the
        frames' validity against the file's end, the spill exchange and
        the norm at global positions around it; bit-equal to the
        whole-file fused gate where only channels are sharded."""
        x, port, ref = world
        out = port[f"fused {(ch, tm)}"]
        n = x["fused"].shape[-1]
        whole = noise_gate_fused(torch.as_tensor(x["fused"]), 1024, 256, 6.0, 60.0, 8).numpy()
        whole = np.concatenate([whole, np.zeros((8, n - whole.shape[-1]), np.float32)], -1)
        if tm == 1:
            np.testing.assert_array_equal(out, whole)
        else:
            assert _snr(whole, out) >= 120.0
        ref_o = oracle.noise_gate(x["fused"].astype(np.float64), 1024, 256, noise_frames=8)
        m = ref_o.shape[-1]
        assert oracle.snr_db(ref_o, out[..., :m].astype(np.float64)) >= 60.0
        assert _snr(ref[f"fused {(ch, tm)}"], out) >= 60.0

    def test_gate_fused_short_shards(self, world):
        """Shards shorter than the floor's frames (l = 2048 < 1024 + 7*256)
        still run the fused path: the floor is sliced from the
        halo-extended signal."""
        _, port, ref = world
        assert _snr(port["short plain"], port["short fused"]) >= 120.0
        assert _snr(ref["short fused"], port["short fused"]) >= 60.0


class TestShardedGateRelease:
    @pytest.mark.parametrize("ch,tm", ((1, 8), (2, 4)))
    def test_release_matches_unsharded(self, world, ch, tm):
        """Release continuity across shards (all_gather of each shard's last
        mask frame) == the whole-file release scan."""
        x, port, ref = world
        out = port[f"release {(ch, tm)}"]
        want = noise_gate(torch.as_tensor(x["release"]), 1024, 256, noise_frames=8,
                          release=0.8).numpy()
        np.testing.assert_allclose(out[..., : want.shape[-1]], want, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(out, ref[f"release {(ch, tm)}"], rtol=1e-8, atol=1e-8)


class TestShardedChain:
    def test_chain_matches_full(self, world):
        """Config 5 spatial form: resample -> FIR -> gate on a (2, 4) mesh."""
        x, port, ref = world
        chain = _port_chains()["chain"]
        chain.build()
        want = chain.full(torch.as_tensor(x["chain"])).numpy()
        np.testing.assert_allclose(port["chain"], want, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(port["chain"], ref["chain"], rtol=1e-7, atol=1e-9)

    def test_composite_stage_matches_components(self, world):
        """ResFIRGateStage shards as its component composition."""
        x, port, ref = world
        chain = _port_chains()["chain"]
        chain.build()
        want = chain.full(torch.as_tensor(x["chain"])).numpy()
        np.testing.assert_allclose(port["comp"], want, rtol=1e-7, atol=1e-9)
        # the JAX sharded composite equals its sharded components (the JAX
        # test's contract), so the JAX components' output stands for it
        np.testing.assert_allclose(port["comp"], ref["chain"], rtol=1e-7, atol=1e-9)

    def test_composite_sharded_fused_f32(self, world):
        """float32: the decomposed components run the kernels (their plain
        versions on the CPU) and match the whole-file composite."""
        x, port, ref = world
        comp = _port_chains()["comp"]
        comp.build()
        assert comp.stages[0]._fg._fir.fused and comp.stages[0]._fg._gate.fused
        assert comp.stages[0]._res.fused
        want = comp.full(torch.as_tensor(x["comp32"])).numpy()
        m = min(want.shape[-1], port["comp32"].shape[-1])
        assert _snr(want[..., :m], port["comp32"][..., :m]) >= 80.0
        assert _snr(ref["comp32"][..., :m], port["comp32"][..., :m]) >= 60.0

    def test_composite_env_stage_matches_components(self, world):
        """A folded envelope shards as its direct-form FIR (|x| halo + MAC):
        the config-5 composite == its four components."""
        x, port, ref = world
        chain = Chain([ResampleStage(up=160, down=147), FIRStage(h=H, nfft=1024),
                       GateStage(**GATE4), EnvelopeStage(HE)])
        chain.build()
        want = chain.full(torch.as_tensor(x["chain"])).numpy()
        np.testing.assert_allclose(port["comp_env"], want, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(port["comp_env"], ref["comp_env"], rtol=1e-7, atol=1e-9)

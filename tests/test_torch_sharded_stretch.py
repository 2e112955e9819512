"""Twins of tests/dist/test_sharded.py's vocoder and streaming tests for the
port's ``parallel`` on a real 8-process gloo world.

One world (``parallel.spawn_local``, 8 ranks) runs every case; this
process computes the JAX package's sharded outputs on the same inputs (8
virtual CPU devices).  Bars: the stretch >= 180 dB against the port's
unsharded ``StretchStage.full`` and the JAX sharded output (the JAX
test's bar; float64); channel-parallel streaming equal to the unsharded
stream at rtol 1e-5 / atol 1e-6 (the JAX test's tolerance; float32), and
>= 60 dB against the JAX channel-sharded stream through its plain steps
(float32 in another summation order: a few borderline gate bins may
decide differently, ROADMAP Queue 3 "by design").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_workers
from audiosignalprocess_tpu import pipeline as jax_pipeline
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.parallel import mesh as jax_mesh
from audiosignalprocess_tpu.parallel import sharded as jax_sharded
from audiosignalprocess_tpu_torch.parallel import spawn_local
from audiosignalprocess_tpu_torch.pipeline import Chain, FIRStage, StretchStage

STRETCH = ((3, 4, 2, 4), (4, 3, 1, 8), (147, 160, 2, 4))
H = oracle.design_fir(64, 0.25)
HS = oracle.design_fir(64, 0.3)
BLOCK = 4 * 16 * 256


def _snr(ref, out):
    return oracle.snr_db(np.asarray(ref, np.float64) + 1e-30,
                         np.asarray(out, np.float64) + 1e-30)


def _inputs():
    rng = np.random.default_rng(29)
    x = {}
    for p, q, ch, tm in STRETCH:
        # the JAX test's shard frames, but one rational period (147) at
        # 147/160, a quarter of its 588, to keep the world short
        m = p if p > 8 else p * max(1, 8 // p + 1) * 4
        x[(p, q)] = rng.standard_normal((4, tm * m * 256))
    x["chain"] = rng.standard_normal((4, 4 * 4 * 16 * 256))
    x["stream"] = rng.standard_normal((8, BLOCK * 4)).astype(np.float32)
    return x


def _stream_chain(mod, fused=True):
    return mod.Chain([mod.FIRStage(h=HS, nfft=1024, fused=fused),
                      mod.GateStage(nfft=1024, hop=256, noise_frames=4, fused=fused),
                      mod.StretchStage(p=4, q=3, nfft=1024, hop=256, fused=fused)])


def _cases(x):
    cases = [(f"stretch {p}/{q}", "stretch", (ch, tm), dict(p=p, q=q, nfft=1024, hop=256),
              x[(p, q)]) for p, q, ch, tm in STRETCH]
    chain = Chain([FIRStage(h=H), StretchStage(p=4, q=3, nfft=1024, hop=256)])
    cases.append(("chain", "chain", (2, 4), dict(chain=chain), x["chain"]))
    cases.append(("stream", "stream", (8, 1), dict(chain=_stream_chain(_torch_pipeline()),
                                                   block=BLOCK), x["stream"]))
    return cases


def _torch_pipeline():
    from audiosignalprocess_tpu_torch import pipeline

    return pipeline


def _jax(fn_of_mesh, x, ch, tm):
    mesh = jax_mesh.make_mesh(channel=ch, time=tm)
    return np.asarray(fn_of_mesh(mesh)(jax_mesh.shard_audio(x, mesh)))


def _jax_outputs(x):
    out = {f"stretch {p}/{q}": _jax(lambda mesh: jax_sharded.sharded_time_stretch(
        mesh, p, q, 1024, 256), x[(p, q)], ch, tm) for p, q, ch, tm in STRETCH}
    jp = jax_pipeline
    chain = jp.Chain([jp.FIRStage(h=H), jp.StretchStage(p=4, q=3, nfft=1024, hop=256)])
    chain.build()
    out["chain"] = _jax(lambda mesh: jax_sharded.sharded_chain(mesh, chain), x["chain"], 2, 4)
    # the JAX plain steps: what the port's steps run on the CPU (the JAX
    # Pallas steps in interpret mode cost a minute of this file's time)
    stream = _stream_chain(jp, fused=False)
    stream.build()
    mesh = jax_mesh.make_mesh(channel=8, time=1)
    fn = jax.jit(lambda v: stream.stream(v, BLOCK),
                 in_shardings=NamedSharding(mesh, P("channel", None)))
    out["stream"] = np.asarray(fn(jnp.asarray(x["stream"])))
    return out


@pytest.fixture(scope="module")
def world():
    """(inputs, port outputs, JAX outputs): one 8-rank world for every case,
    then the JAX outputs in this process."""
    x = _inputs()
    port = spawn_local(torch_dist_workers.run_cases, 8, args=(_cases(x),), device="cpu",
                       timeout_s=240.0)[0]
    return x, port, _jax_outputs(x)


class TestShardedStretch:
    """Sharded phase vocoder == StretchStage.full: phase continuity across
    shards from the gathered per-shard rotor totals."""

    @pytest.mark.parametrize("p,q,ch,tm", STRETCH)
    def test_matches_full(self, world, p, q, ch, tm):
        x, port, ref = world
        st = StretchStage(p=p, q=q, nfft=1024, hop=256)
        st.configure(0)
        want = st.full(torch.as_tensor(x[(p, q)])).numpy()
        out = port[f"stretch {p}/{q}"]
        assert out.shape == want.shape
        assert _snr(want, out) >= 180.0
        assert _snr(ref[f"stretch {p}/{q}"], out) >= 180.0

    def test_chain_with_stretch(self, world):
        """sharded_chain routes StretchStage through stretch_shard_body."""
        x, port, ref = world
        chain = Chain([FIRStage(h=H), StretchStage(p=4, q=3, nfft=1024, hop=256)])
        chain.build()
        want = chain.full(torch.as_tensor(x["chain"])).numpy()
        assert port["chain"].shape == want.shape
        assert _snr(want, port["chain"]) >= 180.0
        assert _snr(ref["chain"], port["chain"]) >= 180.0


class TestShardedStreaming:
    def test_stream_channel_sharded(self, world):
        """Channel-parallel streaming (each rank streams its channels; no
        collectives) equals the unsharded stream."""
        x, port, ref = world
        chain = _stream_chain(_torch_pipeline())
        want = chain.stream(torch.as_tensor(x["stream"]), BLOCK).numpy()
        np.testing.assert_allclose(port["stream"], want, rtol=1e-5, atol=1e-6)
        assert _snr(ref["stream"], port["stream"]) >= 60.0

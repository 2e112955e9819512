"""Twins of tests/dist/test_sharded.py's filters, gate, halo and guard tests
for the port's ``parallel`` on a real 8-process gloo world.

One world (``parallel.spawn_local``, 8 ranks) runs every case of this
file; the JAX package's sharded outputs on the same inputs come from its
shard_map programs on 8 virtual CPU devices in this process.  Each case holds the port's sharded output to the port's
unsharded output and to the JAX sharded output at the JAX tests' own
tolerances.
"""

import queue
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_dist_workers
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.parallel import mesh as jax_mesh
from audiosignalprocess_tpu.parallel import sharded as jax_sharded
from audiosignalprocess_tpu_torch.ops.fir import fir_direct
from audiosignalprocess_tpu_torch.ops.resample import resample_poly
from audiosignalprocess_tpu_torch.parallel import launch, spawn_local
from audiosignalprocess_tpu_torch.pipeline import Chain, GateStage

MESHES = ((1, 8), (8, 1), (2, 4), (4, 2))
H64 = oracle.design_fir(64, 0.25)
H4096 = oracle.design_fir(4096, 0.1)
H512 = oracle.design_fir(512, 0.1)
RESAMPLE = ((160, 147), (2, 1), (3, 4))


def _gate_input(rng, c, n):
    t = np.arange(n) / 48000
    x = 0.01 * rng.standard_normal((c, n))
    return x + np.where((t > 0.2) & (t < 0.5), np.sin(2 * np.pi * 440.0 * t), 0.0)


def _inputs():
    rng = np.random.default_rng(17)
    return dict(
        fir=rng.standard_normal((8, 4096)),
        os4096=rng.standard_normal((8, 8 * 8192)),
        resample={ud: rng.standard_normal((8, ud[1] * 128 * 4)) for ud in RESAMPLE},
        gate=_gate_input(rng, 8, 8192 * 8),
        halo=np.arange(64, dtype=np.float32).reshape(1, 64),
        zero_halo=rng.standard_normal((2, 8 * 64)).astype(np.float32),
        guard_fir=rng.standard_normal((1, 8 * 256)),
        guard_gate=rng.standard_normal((1, 8 * 1024)),
        os_fused=rng.standard_normal((8, 8192)).astype(np.float32),
    )


def _cases(x):
    cases = [(f"fir {m}", "fir", m, dict(h=H64), x["fir"]) for m in MESHES]
    cases += [(f"os4096 {m}", "overlap_save", m, dict(h=H4096, nfft=16384), x["os4096"])
              for m in ((2, 4), (1, 8))]
    cases += [(f"resample {ud}", "resample", (2, 4), dict(up=ud[0], down=ud[1]),
               x["resample"][ud]) for ud in RESAMPLE]
    cases += [(f"gate {m}", "gate", m, {}, x["gate"]) for m in ((8, 1), (2, 4), (1, 8))]
    cases += [("halo_left", "halo_left", (1, 8), dict(halo=2), x["halo"]),
              ("halo_right", "halo_right", (1, 8), dict(halo=3), x["halo"]),
              ("zero halo_left", "halo_left", (1, 8), dict(halo=0), x["zero_halo"]),
              ("zero halo_right", "halo_right", (1, 8), dict(halo=0), x["zero_halo"]),
              ("guard halo", "fir", (1, 8), dict(h=H512), x["guard_fir"]),
              ("guard noise_frames", "gate", (1, 8), {}, x["guard_gate"]),
              ("os fused", "overlap_save", (2, 4), dict(h=H64, nfft=1024, fused=True),
               x["os_fused"])]
    return cases


def _jax(fn_of_mesh, x, ch, tm):
    mesh = jax_mesh.make_mesh(channel=ch, time=tm)
    return np.asarray(fn_of_mesh(mesh)(jax_mesh.shard_audio(x, mesh)))


def _jax_outputs(x):
    out = {f"fir {m}": _jax(lambda mesh: jax_sharded.sharded_fir(mesh, H64), x["fir"], *m)
           for m in MESHES}
    out.update({f"os4096 {m}": _jax(lambda mesh: jax_sharded.sharded_overlap_save(
        mesh, H4096, nfft=16384), x["os4096"], *m) for m in ((2, 4), (1, 8))})
    out.update({f"resample {ud}": _jax(lambda mesh: jax_sharded.sharded_resample(mesh, *ud),
                                       x["resample"][ud], 2, 4) for ud in RESAMPLE})
    out.update({f"gate {m}": _jax(jax_sharded.sharded_noise_gate, x["gate"], *m)
                for m in ((8, 1), (2, 4), (1, 8))})
    out["os fused"] = _jax(lambda mesh: jax_sharded.sharded_overlap_save(
        mesh, H64, 1024, fused=True), x["os_fused"], 2, 4)
    return out


@pytest.fixture(scope="module")
def world():
    """(inputs, port outputs, JAX outputs): one 8-rank world for every case,
    then the JAX outputs in this process."""
    x = _inputs()
    port = spawn_local(torch_dist_workers.run_cases, 8, args=(_cases(x),), device="cpu",
                       timeout_s=240.0)[0]
    return x, port, _jax_outputs(x)


def _port_close(got, want, rtol, atol):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


class TestShardedFIR:
    @pytest.mark.parametrize("ch,tm", MESHES)
    def test_fir_matches_unsharded(self, world, ch, tm):
        x, port, ref = world
        out = port[f"fir {(ch, tm)}"]
        _port_close(out, fir_direct(torch.as_tensor(x["fir"]), H64).numpy(), 1e-9, 1e-9)
        _port_close(out, ref[f"fir {(ch, tm)}"], 1e-9, 1e-9)

    @pytest.mark.parametrize("ch,tm", ((2, 4), (1, 8)))
    def test_overlap_save_4096taps(self, world, ch, tm):
        """Config 4 structure: a long FIR with halo exchange."""
        x, port, ref = world
        out = port[f"os4096 {(ch, tm)}"]
        xo = x["os4096"]
        _port_close(out, np.stack([oracle.fir_direct(xo[i], H4096) for i in range(8)]),
                    1e-8, 1e-8)
        _port_close(out, ref[f"os4096 {(ch, tm)}"], 1e-8, 1e-8)


class TestShardedResample:
    @pytest.mark.parametrize("up,down", RESAMPLE)
    def test_matches_unsharded(self, world, up, down):
        x, port, ref = world
        out = port[f"resample {(up, down)}"]
        want = resample_poly(torch.as_tensor(x["resample"][(up, down)]), up, down,
                             zero_phase=False).numpy()
        _port_close(out, want, 1e-8, 1e-8)
        _port_close(out, ref[f"resample {(up, down)}"], 1e-8, 1e-8)


class TestShardedGate:
    @pytest.mark.parametrize("ch,tm", ((8, 1), (2, 4), (1, 8)))
    def test_matches_full(self, world, ch, tm):
        """Config 3: the channel- and time-sharded STFT noise gate."""
        x, port, ref = world
        out = port[f"gate {(ch, tm)}"]
        chain = Chain([GateStage()])
        chain.build()
        _port_close(out, chain.full(torch.as_tensor(x["gate"])).numpy(), 1e-7, 1e-9)
        _port_close(out, ref[f"gate {(ch, tm)}"], 1e-7, 1e-9)


class TestHaloPrimitives:
    def test_halo_left_right(self, world):
        x, port, _ = world
        xh = x["halo"]
        shards = port["halo_left"].reshape(8, 10)
        np.testing.assert_array_equal(shards[0, :2], [0, 0])
        for s in range(1, 8):
            np.testing.assert_array_equal(shards[s, :2], xh[0, s * 8 - 2 : s * 8])
            np.testing.assert_array_equal(shards[s, 2:], xh[0, s * 8 : (s + 1) * 8])
        out_r = port["halo_right"].reshape(8, 11)
        np.testing.assert_array_equal(out_r[7, 8:], [0, 0, 0])
        for s in range(7):
            np.testing.assert_array_equal(out_r[s, 8:], xh[0, (s + 1) * 8 : (s + 1) * 8 + 3])


class TestGuards:
    """Silently wrong sharded configurations are hard errors."""

    def test_halo_exceeds_shard_raises(self, world):
        _, port, _ = world
        kind, msg = port["guard halo"]
        assert kind == "raised" and "halo" in msg

    def test_noise_frames_exceed_shard_raises(self, world):
        _, port, _ = world
        kind, msg = port["guard noise_frames"]
        assert kind == "raised" and "noise_frames" in msg


class TestHaloEdgeCases:
    def test_zero_halo_is_identity(self, world):
        """halo == 0 returns the shard unchanged (x[..., -0:] would be all
        of it)."""
        x, port, _ = world
        for side in ("left", "right"):
            np.testing.assert_array_equal(port[f"zero halo_{side}"], x["zero_halo"])


class TestFusedSharded:
    def test_overlap_save_fused_per_shard(self, world):
        """The fused overlap-save per shard, its history from the halo."""
        x, port, ref = world
        out = port["os fused"]
        xf = x["os_fused"].astype(np.float64)
        want = np.stack([oracle.fir_direct(xf[i], H64) for i in range(8)])
        assert oracle.snr_db(want, out.astype(np.float64)) >= 60.0
        assert oracle.snr_db(ref["os fused"].astype(np.float64), out.astype(np.float64)) >= 60.0


def test_failing_rank_raises_in_the_parent():
    """A rank that raises makes spawn_local raise, with its traceback,
    though the other ranks wait for it in a collective."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_local(torch_dist_workers.fail_on, 2, args=(1,), device="cpu", timeout_s=120.0)


def test_hanging_rank_times_out_in_the_parent():
    """A rank that never returns makes spawn_local raise at its timeout and
    stop every process of the group."""
    with pytest.raises(TimeoutError, match="of 2 ranks still running after 3.0 s"):
        spawn_local(torch_dist_workers.hang_on, 2, args=(1,), device="cpu", timeout_s=3.0)


def test_spawn_local_defaults_to_the_card(monkeypatch):
    """Without device=..., every rank joins its group on "cuda", as
    ``initialize``'s own default.  A stand-in process context runs each
    rank's body in this process and ``initialize`` records what reaches
    it, so no card is needed."""
    seen = []

    class Proc:  # a stand-in for a spawned process: runs the rank when started
        def __init__(self, target, args, daemon):
            self.target, self.args, self.exitcode = target, args, None

        def start(self):
            self.target(*self.args)
            self.exitcode = 0

        def join(self, timeout=None):
            pass

        def is_alive(self):
            return False

    monkeypatch.setattr(launch.torch.multiprocessing, "get_context",
                        lambda method: SimpleNamespace(Queue=queue.Queue, Process=Proc))
    monkeypatch.setattr(launch.torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(launch, "_claim", lambda device: seen.append(("claim", device)))
    monkeypatch.setattr(launch, "initialize", lambda init_method, world, rank, backend, device:
                        seen.append((rank, backend, device)))
    assert spawn_local(lambda rank, world: rank * 10 + world, 2) == [2, 12]
    assert seen == [("claim", "cuda"), (0, "gloo", "cuda"), (1, "gloo", "cuda")]


def test_spawn_local_default_without_a_card_raises():
    """With no GPU the default device raises torch's own error before any
    rank starts, as the api one-shots do; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        spawn_local(torch_dist_workers.fail_on, 2, args=(1,), timeout_s=30.0)

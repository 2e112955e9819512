"""The port's polyphase resampler vs the JAX package's: ``resample_poly``,
``resample_mac`` (its plain version on the CPU) and ``ResampleStage``.

Twins of tests/kernels/test_mac_kernels.py::TestResampleMac and of the
resampler cases of tests/unit/test_pipeline.py.  JAX runs as its own tests
run it (tests/conftest.py: CPU, x64, Pallas in interpret mode), so JAX's
``resample_mac`` runs its Pallas kernel in interpret mode.

Tolerances: float64 rtol 1e-8, atol 1e-8 (JAX's own bar for the
resampler); float32 >= 60 dB against the float64 oracle.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu import pipeline as J
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu.kernels.resample_kernel import resample_mac as jax_resample_mac
from audiosignalprocess_tpu.ops.resample import resample_poly as jax_resample_poly
from audiosignalprocess_tpu_torch import pipeline as P
from audiosignalprocess_tpu_torch.kernels.resample_kernel import (
    res_window, resample_mac, resample_mac_ref,
)
from audiosignalprocess_tpu_torch.ops.resample import history_len, resample_poly

F64 = dict(rtol=1e-8, atol=1e-8)
RATIOS = ((160, 147), (147, 160), (2, 1), (1, 2), (3, 4))


@pytest.fixture()
def rng():
    return np.random.default_rng(31)


def _oracle(x, up, down, zero_phase=True):
    return np.stack([oracle.resample_poly(r, up, down, zero_phase=zero_phase) for r in x])


@pytest.mark.parametrize("up,down", RATIOS)
@pytest.mark.parametrize("zero_phase", (True, False))
def test_resample_poly_vs_jax(rng, up, down, zero_phase):
    """Every ratio x zero_phase, odd length: the JAX resample_poly and the
    oracle, float64."""
    x = rng.standard_normal((2, 2940 + 7))
    out = resample_poly(torch.as_tensor(x), up, down, zero_phase=zero_phase).numpy()
    ref = np.asarray(jax_resample_poly(jnp.asarray(x), up, down, zero_phase=zero_phase))
    assert out.shape == ref.shape == (2, -(-x.shape[-1] * up // down))
    np.testing.assert_allclose(out, ref, **F64)
    np.testing.assert_allclose(out, _oracle(x, up, down, zero_phase), **F64)


def test_resample_poly_gcd_and_identity(rng):
    """320/294 reduces to 160/147; 5/5 is the identity."""
    x = torch.as_tensor(rng.standard_normal((2, 1470)))
    np.testing.assert_array_equal(resample_poly(x, 320, 294).numpy(),
                                  resample_poly(x, 160, 147).numpy())
    assert resample_poly(x, 5, 5) is x
    assert resample_mac(x, 7, 7) is x


@pytest.mark.parametrize("up,down", ((160, 147), (2, 1), (3, 4)))
def test_resample_poly_streaming_history(rng, up, down):
    """Block by block with the carried history: the JAX block outputs and
    the oracle's causal whole stream."""
    h = oracle.resample_filter(up, down)
    hl = history_len(len(h), up, down)
    b = down * 40
    x = rng.standard_normal((2, 4 * b))
    hist = np.zeros((2, hl))
    outs = []
    for k in range(4):
        blk = x[:, k * b : (k + 1) * b]
        y = resample_poly(torch.as_tensor(blk), up, down, h=h, zero_phase=False,
                          history=torch.as_tensor(hist)).numpy()
        ref = np.asarray(jax_resample_poly(jnp.asarray(blk), up, down, h=h,
                                           zero_phase=False, history=jnp.asarray(hist)))
        np.testing.assert_allclose(y, ref, **F64)
        outs.append(y)
        hist = np.concatenate([hist, blk], axis=-1)[:, -hl:]
    np.testing.assert_allclose(np.concatenate(outs, axis=-1),
                               _oracle(x, up, down, zero_phase=False), **F64)


@pytest.mark.parametrize("up,down", ((160, 147), (147, 160)))
def test_resample_poly_f32_snr(rng, up, down):
    x = rng.standard_normal((2, 14700)).astype(np.float32)
    out = resample_poly(torch.as_tensor(x), up, down)
    assert out.dtype == torch.float32
    assert oracle.snr_db(_oracle(x.astype(np.float64), up, down), out.numpy()) >= 60.0


@pytest.mark.parametrize("kw,match", [
    (dict(zero_phase=True, hist=147), "causal"),
    (dict(zero_phase=False, hist=148), "multiples of down"),
    (dict(zero_phase=False, hist=0, n=1471), "multiples of down"),
])
def test_resample_history_contract(kw, match):
    """The history contract raises as the JAX package's does."""
    x = torch.zeros(1, kw.get("n", 1470), dtype=torch.float64)
    hist = torch.zeros(1, kw["hist"], dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        resample_poly(x, 160, 147, zero_phase=kw["zero_phase"], history=hist)
    with pytest.raises(ValueError):
        jax_resample_poly(jnp.asarray(x.numpy()), 160, 147, zero_phase=kw["zero_phase"],
                          history=jnp.asarray(hist.numpy()))


def test_resample_history_too_short_raises():
    """3/4 needs nk-1 = 20 samples of history; 8 (a multiple of down) is
    too short."""
    with pytest.raises(ValueError, match="history_len"):
        resample_poly(torch.zeros(1, 400), 3, 4, zero_phase=False, history=torch.zeros(1, 8))


class TestResampleMac:
    """Twins of the JAX package's TestResampleMac: on a CPU tensor the
    wrapper runs its plain version, with no launch."""

    @pytest.mark.parametrize("up,down", RATIOS)
    @pytest.mark.parametrize("zero_phase", (True, False))
    def test_vs_oracle(self, rng, up, down, zero_phase):
        x = rng.standard_normal((2, 2940))
        before = resample_mac.launches
        out = resample_mac(torch.as_tensor(x), up, down, zero_phase=zero_phase).numpy()
        assert resample_mac.launches == before
        ref = np.asarray(jax_resample_mac(x, up, down, zero_phase=zero_phase, cycle_tile=64))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, **F64)
        np.testing.assert_allclose(out, _oracle(x, up, down, zero_phase), **F64)

    def test_streaming_history(self, rng):
        up, down = 160, 147
        n = down * 64 * 3
        x = rng.standard_normal(n)
        h = oracle.resample_filter(up, down)
        hl = history_len(len(h), up, down)
        b = down * 64
        hist = np.zeros((1, hl))
        outs = []
        for k in range(0, n, b):
            blk = x[None, k : k + b]
            y = resample_mac(torch.as_tensor(blk), up, down, h=h, zero_phase=False,
                             history=torch.as_tensor(hist)).numpy()[0]
            ref = np.asarray(jax_resample_mac(blk, up, down, h=h, zero_phase=False,
                                              history=hist, cycle_tile=32))[0]
            np.testing.assert_allclose(y, ref, **F64)
            outs.append(y)
            hist = np.concatenate([hist, blk], axis=-1)[:, -hl:]
        np.testing.assert_allclose(np.concatenate(outs),
                                   oracle.resample_poly(x, up, down, zero_phase=False), **F64)

    def test_f32_snr(self, rng):
        x = rng.standard_normal((4, 14700)).astype(np.float32)
        ref = _oracle(x.astype(np.float64), 160, 147)
        out = resample_mac(torch.as_tensor(x), 160, 147)
        assert out.dtype == torch.float32
        assert oracle.snr_db(ref, out.numpy()) >= 60.0
        assert torch.equal(out, resample_mac_ref(torch.as_tensor(x), 160, 147))

    @pytest.mark.parametrize("up,down", RATIOS)
    def test_window_bounds_every_tile(self, up, down):
        """res_window(count) is the most raw samples any run of ``count``
        consecutive outputs reads (the kernel's shared-memory staging)."""
        h = oracle.resample_filter(up, down)
        nk = -(-len(h) // up)
        for delay in (0, (len(h) - 1) // 2):
            for count in (1, 7, 1024):
                j0 = np.arange(0, 3 * up * down)
                first = (j0 * down + delay) // up - (nk - 1)
                last = ((j0 + count - 1) * down + delay) // up
                assert (last - first + 1).max() <= res_window(count, up, down, nk)


class TestResampleStage:
    @pytest.mark.parametrize("up,down", ((160, 147), (1, 2), (3, 4)))
    def test_stream_equals_full(self, rng, up, down):
        """Twin of the JAX TestResampleStage: stream == full (latency 0),
        and both equal the JAX stage's."""
        block = down * 32
        x = rng.standard_normal((2, block * 8))
        pc, jc = P.Chain([P.ResampleStage(up=up, down=down)]), J.Chain([J.ResampleStage(up=up, down=down)])
        assert pc.build() == jc.build() == 0
        y = pc.stream(torch.as_tensor(x), block).numpy()
        full = pc.full(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(y, full[..., : y.shape[-1]], rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(y, np.asarray(jc.stream(jnp.asarray(x), block)), **F64)

    def test_drain_length_is_rate_map(self, rng):
        """out_len is the ceil rate map (147 -> 160, 148 -> 162 at 160/147);
        a drained stream of a length off the block equals full_flush and the
        JAX drained stream."""
        pc, jc = P.Chain([P.ResampleStage(up=160, down=147)]), J.Chain([J.ResampleStage(up=160, down=147)])
        pc.build(), jc.build()
        assert pc.out_len(147) == 160 and pc.out_len(148) == 162
        x = rng.standard_normal((2, 14700 + 123))
        assert pc.drain_blocks(x.shape[-1], 1470) == jc.drain_blocks(x.shape[-1], 1470)
        y = pc.stream(torch.as_tensor(x), 1470, drain=True).numpy()
        assert y.shape == (2, pc.out_len(x.shape[-1]))
        np.testing.assert_allclose(y, pc.full_flush(torch.as_tensor(x)).numpy(),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(y, np.asarray(jc.stream(jnp.asarray(x), 1470, drain=True)),
                                   **F64)

    def test_geometry_and_checks(self):
        """configure, out_block, tail_width and init_state equal the JAX
        stage's; a block or upstream latency off ``down`` raises."""
        ps, js = P.ResampleStage(160, 147), J.ResampleStage(160, 147)
        assert (ps.configure(294), ps.out_block(4704), ps.tail_width(1023)) == \
            (js.configure(294), js.out_block(4704), js.tail_width(1023))
        assert ps.init_state((3,), 4704).shape == js.init_state((3,), 4704, jnp.float32).shape
        for bad in (lambda: ps.configure(100), lambda: ps.out_block(4410 + 1)):
            with pytest.raises(ValueError, match="multiple of down"):
                bad()

    def test_fused_routes_f32_through_resample_mac(self, rng):
        """fused=True takes resample_mac for float32 (its plain version on
        the CPU: equal output, no launch); float64 stays on resample_poly."""
        x = torch.as_tensor(rng.standard_normal((2, 1470 * 4)).astype(np.float32))
        before = resample_mac.launches
        fused = P.Chain([P.ResampleStage(160, 147, fused=True)]).stream(x, 1470)
        assert resample_mac.launches == before
        assert torch.equal(fused, P.Chain([P.ResampleStage(160, 147)]).stream(x, 1470))

    def test_from_params(self, rng):
        """A JAX ResampleStage's fields (asdict) build the same stage."""
        js = J.ResampleStage(up=320, down=294, fused=True)
        pc = P.Chain.from_params([dict(dataclasses.asdict(js), stage="ResampleStage")])
        st = pc.stages[0]
        assert isinstance(st, P.ResampleStage) and (st.up, st.down, st.fused) == (160, 147, True)
        np.testing.assert_array_equal(st.h, js.h)
        x = rng.standard_normal((1, 1470 * 2))
        np.testing.assert_allclose(pc.stream(torch.as_tensor(x), 1470).numpy(),
                                   np.asarray(J.Chain([js]).stream(jnp.asarray(x), 1470)),
                                   **F64)

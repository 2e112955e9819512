"""The host side of the streaming phase-vocoder step on batched register
Stockham transforms (``csrc/stretch_step_regs.cuh``), on the CPU.

A float64 numpy model of the kernel's schedule, on the pass-level
transforms of ``tests/test_torch_chain_regs.py`` (every pass of
``regs_pass_plan``, the swizzled exchange NaN-filled, the merged passes'
bin pairs): per block the analysis in batches of 2B frames read from
[in_tail | x] (each bin pair untangled into its two frames' FIFO rows, z0
from the first true frame), with a cluster of two CTAs the analysis and
then the synthesis frames split in whole batches (``step_split``), z0
taken from the CTA that analysed the first true frame, the second CTA
reaching acc at its first frame by the rotors of the first CTA's frames;
the synthesis batches (the rotor recursion per bin in frame order into
the batch's synthesis bins, the inverse's merged first pass rebuilding Z =
A + iB, the overlap-add pass, the second CTA from a zero carry, the
first's final carry added to its first positions after both).  Stepped
through StretchStage streams in place of ``stretch_step_ref``: every
block >= 200 dB and every carry equal (to rounding) against the plain
step on the same carry, every output and carry position written once
(NaN-filled), at 4/3, 3/4, 1/2 and 147/160,
nfft 256/64 and 1024/256 (and 8192/2048 at one CTA), drained and not;
and the model's float64 stream against the JAX package's plain
StretchStage stream.  ``stretch_regs_geometry`` fits SMEM_LIMIT up to
nfft 8192 and raises naming it past.
"""

import numpy as np
import pytest
import torch

from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels import gate_kernel as gk
from audiosignalprocess_tpu_torch.kernels import stretch_kernel as sk
from audiosignalprocess_tpu_torch.kernels._build import SMEM_LIMIT

from test_torch_chain_regs import (
    _assert_carries_equal, _bin_pairs, _forward, _inverse, _layout, _snr, _to_inverse_slots,
)


def _unit(z):
    """unit_rotor: z / |z|, 1 where |z|^2 <= 1e-36."""
    m2 = z.real ** 2 + z.imag ** 2
    return np.where(m2 > 1e-36, z / np.sqrt(np.where(m2 > 1e-36, m2, 1.0)), 1.0 + 0j)


def stretch_step_model(x, state, *, nfft, hop, p, q, n_skip, off, window_kind,
                       eof_frames_out=None, cluster=1):
    """asp::stretch_step_regs in float64: one block x (C, m hop) with the
    plain step's carry, the signature of stretch_step_ref.  ``cluster`` 2:
    two CTAs a channel, each with its own analysis and synthesis frames."""
    xn = x.numpy()
    n_ch, b = xn.shape
    big_n, hp = nfft, hop
    m, mo = sk.stretch_block_frames(b, hp, p, q)
    _, _, rs, lg, _, nt = _layout(big_n)
    nb, d, nfb = big_n // 2 + 1, big_n - hp, 2 * nt
    depth, slots, fracs = sk.stretch_slots(m, p, q, n_skip, off)
    blk = int(state["blk"])
    hit, lo, hi, i0, eof_out = sk.stretch_step_masks(blk, m, mo, n_skip, off, big_n, hp,
                                                     eof_frames_out)
    twf = fk.stockham_stage_table_np(big_n, -1.0)
    twi = fk.stockham_stage_table_np(big_n, 1.0)
    win, head, const, tail = gk._step_tables_np(big_n, hp, window_kind)
    pairs = _bin_pairs(big_n)
    up = 2 * pairs[:, 5] > big_n
    kk = np.where(up, big_n - pairs[:, 5], pairs[:, 5])
    edge = (kk == 0) | (2 * kk == big_n)
    a_split = gk.step_split(m, big_n, cluster)
    s_split = gk.step_split(mo, big_n, cluster)
    ranks_a = [(0, a_split), (a_split, m)]
    ranks_s = [(0, s_split), (s_split, mo)]
    p0 = i0 * hp

    def inv_norm(pos):
        v = np.where(pos < 0, 1.0, np.where(pos < d, 1.0 / head[np.clip(pos, 0, d - 1)],
                                            1.0 / const))
        if eof_out is not None:
            ti = np.clip(pos - (eof_out - d), 0, d - 1)
            v = np.where(pos >= eof_out, 1.0, np.where(pos >= eof_out - d, 1.0 / tail[ti], v))
        return v

    st = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
    out = np.full((n_ch, mo * hp), np.nan)
    written = np.zeros((n_ch, mo * hp), np.int64)
    new = dict(in_tail=np.full((n_ch, d), np.nan), fifo=np.full((n_ch, depth, nb), np.nan + 0j),
               z0=np.full((n_ch, nb), np.nan + 0j), acc=np.full((n_ch, nb), np.nan + 0j),
               ola_tail=np.full((n_ch, d), np.nan))
    rows_written = np.zeros((n_ch, depth, nb), np.int64)
    for c in range(n_ch):
        ext = np.concatenate([st["in_tail"][c], xn[c]])
        fifo = new["fifo"][c]
        keep = max(depth - m, 0)
        fifo[:keep] = st["fifo_r"][c, m: m + keep] + 1j * st["fifo_i"][c, m: m + keep]
        rows_written[c, :keep] += 1
        z0_in = st["z0r"][c, 0] + 1j * st["z0i"][c, 0]
        acc_in = st["accr"][c, 0] + 1j * st["acci"][c, 0]
        z0 = [z0_in.copy(), z0_in.copy()]  # each CTA's
        # ---- analysis, each CTA its frames
        for rank, (a_lo, a_hi) in enumerate(ranks_a):
            for q0 in range(a_lo, a_hi, nfb):
                nfr = min(nfb, a_hi - q0)

                def load(idx, q0=q0, nfr=nfr):
                    t, i = idx // big_n, idx % big_n
                    e = (q0 + 2 * t) * hp + i
                    re = np.where(2 * t < nfr, ext[np.minimum(e, len(ext) - 1)] * win[i], 0.0)
                    im = np.where(2 * t + 1 < nfr,
                                  ext[np.minimum(e + hp, len(ext) - 1)] * win[i], 0.0)
                    return re + 1j * im

                z = _forward(big_n, load, twf)
                zk, zn = z[:, pairs[:, 1], pairs[:, 2]], z[:, pairs[:, 3], pairs[:, 4]]
                pa, qa = np.where(up, zn, zk), np.where(up, zk, zn)
                specs = (0.5 * (pa + np.conj(qa)), -0.5j * (pa - np.conj(qa)))
                for t in range(nt):
                    for e in (0, 1):
                        fa = 2 * t + e
                        if fa >= nfr:
                            continue
                        j, spec = q0 + fa, specs[e][t]
                        row = depth - m + j
                        if row >= 0:
                            fifo[row, kk] = spec
                            rows_written[c, row, kk] += 1
                        if j == hit:
                            z0[rank][kk] += _unit(spec)
        # the CTAs meet: z0 from the one that analysed the first true frame
        if hit >= 0:
            z0[0] = z0[1] = z0[0 if hit < a_split else 1]
        new["z0"][c] = z0[0]

        def rotor(u):
            s0, s1 = fifo[slots[u]], fifo[slots[u] + 1]
            return _unit(s1 * np.conj(s0)) if lo <= u < hi else np.ones(nb, complex)

        # ---- synthesis, each CTA its frames
        carry0 = None
        for rank, (s_lo, s_hi) in enumerate(ranks_s):
            if s_lo == s_hi:
                continue
            acc = acc_in.copy()
            for u in range(s_lo):  # the second CTA: the rotors of the first's frames
                acc = acc * rotor(u)
            # the second CTA overlap-adds from a zero carry; the first's is added after
            carry = st["ola_tail"][c].copy() if rank == 0 else np.zeros(d)
            for q0 in range(s_lo, s_hi, nfb):
                nfr = min(nfb, s_hi - q0)
                syn = np.zeros((nfb, nb), complex)
                for fa in range(nfr):  # the recursion, frame by frame
                    u = q0 + fa
                    s0, s1 = fifo[slots[u]], fifo[slots[u] + 1]
                    emit = lo <= u < hi
                    mag = ((1.0 - fracs[u]) * np.abs(s0) + fracs[u] * np.abs(s1)) * emit
                    syn[fa] = mag * (z0[rank] * acc)
                    acc = acc * rotor(u)
                xz = np.full((nt, 1 << lg, 1 << rs), np.nan + 0j)
                for t in range(nt):
                    ya = np.where(edge, syn[2 * t, kk].real, syn[2 * t, kk])
                    yb = np.where(edge, syn[2 * t + 1, kk].real, syn[2 * t + 1, kk])
                    ya, yb = np.where(up, np.conj(ya), ya), np.where(up, np.conj(yb), yb)
                    xz[t, pairs[:, 1], pairs[:, 2]] = ya + 1j * yb
                    xz[t, pairs[:, 3], pairs[:, 4]] = np.conj(ya) + 1j * np.conj(yb)
                assert not np.isnan(xz).any(), "a slot of the synthesis pass was never set"
                stage = np.full(nt * big_n, np.nan + 0j)

                def store(idx, v):
                    stage[idx] = v * (win[idx % big_n] / big_n)

                _inverse(big_n, _to_inverse_slots(xz, rs), store, twi)
                fin = nfr * hp
                v = np.concatenate([carry, np.zeros(fin)])
                for fq in range(nfr):
                    fr = stage[(fq >> 1) * big_n: (fq >> 1) * big_n + big_n]
                    v[fq * hp: fq * hp + big_n] += fr.imag if fq & 1 else fr.real
                gp = q0 * hp + np.arange(fin)
                out[c, gp] = v[:fin] * inv_norm(p0 + gp)
                written[c, gp] += 1
                carry = v[fin:]
            if rank == 0:
                carry0 = carry
            if s_hi == mo:
                new["ola_tail"][c] = carry
                new["acc"][c] = acc
            if rank == 1:  # the first CTA's final carry into its first d positions
                tot = (s_hi - s_lo) * hp
                j = np.arange(d)
                gp = s_lo * hp + j[j < tot]
                out[c, gp] += carry0[j < tot] * inv_norm(p0 + gp)
                new["ola_tail"][c, j[j >= tot] - tot] += carry0[j >= tot]
        new["in_tail"][c] = ext[m * hp: m * hp + d]
    assert (written == 1).all() and not np.isnan(out).any()
    assert (rows_written == 1).all(), "a FIFO row position written twice or never"
    for v in new.values():
        assert not np.isnan(v).any(), "a carry position was never written"
    shape = lambda a, key: torch.as_tensor(a).reshape(state[key].shape)
    return dict(in_tail=shape(new["in_tail"], "in_tail"),
                fifo_r=shape(new["fifo"].real, "fifo_r"), fifo_i=shape(new["fifo"].imag, "fifo_i"),
                z0r=shape(new["z0"].real, "z0r"), z0i=shape(new["z0"].imag, "z0i"),
                accr=shape(new["acc"].real, "accr"), acci=shape(new["acc"].imag, "acci"),
                ola_tail=shape(new["ola_tail"], "ola_tail"), blk=blk + 1), \
        torch.as_tensor(out).reshape(x.shape[:-1] + (mo * hp,))


def _model_stream(monkeypatch, chain, x, block, drain, cluster):
    """chain.stream in float64 with the model in place of the plain step;
    each block also checked against the plain step on the same carry."""
    from audiosignalprocess_tpu_torch import pipeline

    plain = pipeline.stretch_step_ref

    def model_step(xb, st, impl="torch", **kw):
        # the stage hands the plain step its impl; the model's transforms
        # are the kernel's
        new, y = stretch_step_model(xb, st, cluster=cluster, **kw)
        want_st, want_y = plain(xb, st, impl=impl, **kw)
        if float(want_y.abs().max()) > 0.0:
            assert _snr(want_y.numpy(), y.numpy()) >= 200.0
        else:  # a block inside the latency: silence
            assert float(y.abs().max()) < 1e-12
        _assert_carries_equal(new, want_st)
        return new, y

    monkeypatch.setattr(pipeline, "stretch_step_ref", model_step)
    y = chain.stream(x, block, drain=drain).numpy()
    monkeypatch.setattr(pipeline, "stretch_step_ref", plain)
    return y


def _block(p, hop):
    """The card tests' block: m = p (16 // p + 1) frames."""
    return p * max(1, 16 // p + 1) * hop


CASES = [  # (p, q, nfft, hop, drain, blocks)
    (4, 3, 1024, 256, False, 4), (4, 3, 256, 64, True, 4),
    (3, 4, 1024, 256, True, 4), (3, 4, 256, 64, False, 4),
    (1, 2, 1024, 256, False, 4), (1, 2, 256, 64, True, 5),
    (147, 160, 1024, 256, True, 2), (147, 160, 256, 64, False, 2),
]


@pytest.mark.parametrize("cluster", (1, 2))
@pytest.mark.parametrize("p,q,nfft,hop,drain,blocks", CASES)
def test_stretch_model_is_the_plain_step(monkeypatch, p, q, nfft, hop, drain, blocks, cluster):
    """The stretch step's model, one CTA or a cluster of two per channel,
    stepped through a StretchStage stream in place of stretch_step_ref:
    each block >= 200 dB and every carry equal (to rounding) against the
    plain step on the same carry, and the stream against the plain stream;
    every output, FIFO row and carry position written once."""
    from audiosignalprocess_tpu_torch.pipeline import Chain, StretchStage

    rng = np.random.default_rng(p * 1000 + q + nfft)
    block = _block(p, hop)
    x = torch.as_tensor(rng.standard_normal((2, blocks * block + (321 if drain else 0))))
    chain = Chain([StretchStage(p, q, nfft=nfft, hop=hop)])
    chain.build()
    got = _model_stream(monkeypatch, chain, x, block, drain, cluster)
    ref = chain.stream(x, block, drain=drain).numpy()
    assert _snr(ref, got) >= 200.0


def test_stretch_model_at_nfft_8192(monkeypatch):
    """nfft 8192, hop 2048: one CTA of 512 threads, one transform a batch
    (two frames), the recursion for both frames in the merged pass."""
    from audiosignalprocess_tpu_torch.pipeline import Chain, StretchStage

    assert gk.step_cluster(8192) == 1 and gk.regs_batch(8192) == 1
    rng = np.random.default_rng(8192)
    block = 12 * 2048
    x = torch.as_tensor(rng.standard_normal((1, 3 * block + 321)))
    chain = Chain([StretchStage(4, 3, nfft=8192, hop=2048)])
    chain.build()
    got = _model_stream(monkeypatch, chain, x, block, True, 1)
    ref = chain.stream(x, block, drain=True).numpy()
    assert _snr(ref, got) >= 200.0


@pytest.mark.parametrize("cluster", (1, 2))
@pytest.mark.parametrize("p,q,drain", [(4, 3, False), (147, 160, True)])
def test_stretch_model_is_the_jax_plain_step(monkeypatch, p, q, drain, cluster):
    """The model's float64 stream against the JAX package's StretchStage
    float64 stream (its plain step) on the same input: allclose at the
    port's float64 tolerance."""
    from audiosignalprocess_tpu import pipeline as J
    import jax.numpy as jnp

    from audiosignalprocess_tpu_torch.pipeline import Chain, StretchStage

    rng = np.random.default_rng(p + q)
    block = _block(p, 256)
    x = rng.standard_normal((2, (2 if p > 16 else 4) * block + (321 if drain else 0)))
    jc, pc = J.Chain([J.StretchStage(p=p, q=q)]), Chain([StretchStage(p, q)])
    assert jc.build() == pc.build()
    got = _model_stream(monkeypatch, pc, torch.as_tensor(x), block, drain, cluster)
    want = np.asarray(jc.stream(jnp.asarray(x), block, drain=drain))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_stretch_geometry():
    """stretch_regs_geometry: z0, acc, the carries, the synthesis bins (none
    at 8192) and the exchange within SMEM_LIMIT from nfft 4 to 8192, one
    CTA an SM at the headline's 220 registers' worth (over half the SM's
    shared memory is not needed: the block's span stays in device memory);
    a cluster of two up to 4096; past 8192 a ValueError naming
    SMEM_LIMIT."""
    for k in range(2, 14):
        nfft = 1 << k
        for hop in {max(1, nfft // 4), max(1, nfft // 8)}:
            geo = sk.stretch_regs_geometry(nfft, hop)
            nb, d = nfft // 2 + 1, nfft - hop
            assert geo["o_carry"] == 4 * nb and geo["o_syn"] == 4 * nb + 2 * d
            syn = 0 if nfft == 8192 else 4 * gk.regs_batch(nfft) * nb
            assert geo["o_ex"] == geo["o_syn"] + syn
            assert geo["smem"] <= SMEM_LIMIT
            assert geo["cluster"] == (1 if nfft == 8192 else 2)
    assert sk.stretch_regs_geometry(1024, 256)["smem"] == 112720
    for nfft in (16384, 32768):
        with pytest.raises(ValueError, match="SMEM_LIMIT"):
            sk.stretch_regs_geometry(nfft, nfft // 4)

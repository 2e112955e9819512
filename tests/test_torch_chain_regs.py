"""The host side of the kernels on batched register Stockham transforms
(``csrc/chain_regs_device.cuh``): fir_noise_gate_fused,
resample_fir_gate_fused and, with the FIR switched off, noise_gate_fused
and gate_shard_fused, on the CPU.

- A numpy model of the kernels' body in float64: tiles (with the halo of
  the parallel launch, or one walker per channel when release > 0),
  batches of 2B frames or overlap-save blocks (B = 256 R / N transforms),
  every pass of ``regs_pass_plan`` on the threads' groups, the swizzled
  exchange (NaN-filled, so a read of an unwritten point shows), the
  forward's last pass merged with the per-bin work and the inverse's first
  pass (the slot identity), the gate's mirror pairs (``for_bin_pairs``),
  the release scan along a batch's frames, and the overlap-add's
  ownership of output positions (each written once).  It agrees with
  ``fir_noise_gate_ref`` and ``resample_fir_gate_ref`` to rounding
  (>= 200 dB) with no mask decision that differs, at nfft 256 to 2048,
  hops nfft/2 to nfft/8, 1 to 384 taps, release 0 and 0.6, one tile and
  many, odd frame counts; without the FIR it agrees with
  ``noise_gate_ref`` (nfft 256 to 4096) and, as one time shard (a null
  1/WOLA table, an output of l + d samples, 0 to l/hop valid frames),
  with ``gate_shard_ref``, every position of a NaN-filled output written
  once.
- The slot identity and the mirror pairing hold for every pass plan (nfft
  2 to 4096): the forward's last pass leaves bin brev(j) 2^lg + q in slot
  j of group q, the inverse's first pass reads exactly those bins, and the
  pairs visit every bin of a transform once, each with its mirror.
- Every exchange access of the plan touches 32 banks under the swizzle.
- ``regs_geometry`` fills whole batches, fits SMEM_LIMIT (both chain
  kernels, config 5's 3201 resampler taps included; the gate alone) and
  accepts every geometry the retired radix-2 body accepted.
- chip_smoke's rule for the hops where the sharded gate may differ from
  the whole-file gate follows the two launches' frame pairing.
- nfft 8192: one transform of 512 threads a batch and one exchange buffer
  (``regs_one_buffer``) fit SMEM_LIMIT for the gate, its shard, the chain
  and the resampler's tail, release 0 and 0.6, and the model agrees with
  the plain versions there; past 8192 every geometry raises naming
  SMEM_LIMIT.
- A float64 numpy model of the streaming step body
  (``csrc/fir_gate_step_regs.cuh``: segments of new frames, the FIR
  batches in place, analysis batches to the FIFO or the pop buffer, the
  floor in frame order, synthesis batches from the popped spectra with the
  release scan, the overlap-add pass, the envelope over the rectified row)
  on the same pass-level transforms, stepped block by block in place of
  the plain step: it agrees with ``fir_gate_step_ref`` and
  ``res_fir_gate_step_ref`` (>= 200 dB, every carry equal to rounding) and
  with the JAX package's float64 plain step stream, on partial last
  batches, m below and above the noise frames, m odd, drained streams and
  release carried across batches and blocks; ``step_regs_geometry`` fits
  every shape the card tests and chip_smoke launch.
"""

import functools

import numpy as np
import pytest
import torch

from audiosignalprocess_tpu_torch.kernels import chain_kernel as ck
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels import res_chain_kernel as rk
from audiosignalprocess_tpu_torch.kernels._build import SMEM_LIMIT
from audiosignalprocess_tpu_torch.kernels import gate_kernel as gk
from audiosignalprocess_tpu_torch.kernels.gate_kernel import _inv_norm_table
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.ops.resample import (
    reduce_ratio, resample_filter, resample_poly, taps_per_phase,
)
from audiosignalprocess_tpu_torch.ops.stft import frame, stft
from audiosignalprocess_tpu_torch.ops.windows import window_np

THREADS = gk.REGS_THREADS
NOISE_FRAMES = 4
PLAN_SIZES = [1 << k for k in range(1, 13)]  # 2 to 4096


def _brev(v, bits):
    out = 0
    for k in range(bits):
        out |= ((v >> k) & 1) << (bits - 1 - k)
    return out


def _brev_np(v, bits):
    v = np.asarray(v)
    out = np.zeros_like(v)
    for k in range(bits):
        out |= ((v >> k) & 1) << (bits - 1 - k)
    return out


def _swizzle(i):
    """csrc/fft_regs.cuh pease_swizzle."""
    x = (i >> 5) & 15
    parity = (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3)) & 1
    return i ^ x ^ (parity << 4) ^ ((i >> 9) & 7)


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref ** 2) / err)


# ---------------------------------------------------------------------------
# the body's index maps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layout(n):
    """(R, RS, rs, lg, G, B): points a thread, points a group of the merged
    pass (2^rs), log2 of its groups a transform, threads a transform,
    transforms a batch."""
    fwd, inv = gk.regs_pass_plan(n)
    rs = fwd[-1][1]
    assert inv[0] == (0, rs)
    big_r = gk.regs_points(n)
    return big_r, 1 << rs, rs, n.bit_length() - 1 - rs, n // big_r, gk.regs_batch(n)


@functools.lru_cache(maxsize=None)
def _bin_pairs(n):
    """for_bin_pairs of every unit of a transform: rows (unit, q_a, j_a, q_b,
    j_b, k), slot j_a of group q_a holding bin k and slot j_b of group q_b
    its mirror (the same slot where k = n - k)."""
    _, rs_pts, rs, lg, _, _ = _layout(n)
    units = 1 if lg == 0 else 1 << (lg - 1)
    rows = []
    for u in range(units):
        if u != 0:
            q2 = (1 << lg) - u
            rows += [(u, u, j, q2, rs_pts - 1 - j, (_brev(j, rs) << lg) + u)
                     for j in range(rs_pts)]
            continue
        for j in range(rs_pts):
            b = _brev(j, rs)
            if b <= rs_pts // 2:
                rows.append((0, 0, j, 0, _brev((rs_pts - b) & (rs_pts - 1), rs), b << lg))
        if lg > 0:
            q2 = 1 << (lg - 1)
            rows += [(0, q2, j, q2, rs_pts - 1 - j, (_brev(j, rs) << lg) + q2)
                     for j in range(rs_pts // 2)]
    return np.array(rows, dtype=np.int64)


def _read_idx(n, nt, s0, r):
    """Batch-local indices (nt, 2^lg, 2^r) a pass from s0 reads (group q of
    transform t, slot j) and the groups' segments l."""
    big_l = n.bit_length() - 1
    lg = big_l - r
    pw = lg - s0
    q = np.arange(1 << lg)
    l, p = q >> pw, q & ((1 << pw) - 1)
    base = np.arange(nt)[:, None] * n + (l << (big_l - s0)) + p
    return base[..., None] + (np.arange(1 << r) << pw), np.broadcast_to(l, (nt, 1 << lg))


def _write_idx(n, nt, r):
    """Batch-local indices (nt, 2^lg, 2^r) a pass writes: slot j of group q
    at q + brev_r(j) 2^lg."""
    big_l = n.bit_length() - 1
    lg = big_l - r
    q = np.arange(1 << lg)
    return (np.arange(nt)[:, None, None] * n + q[None, :, None]
            + (_brev_np(np.arange(1 << r), r) << lg))


def _stages(pts, s0, r, tab, l):
    """stockham_pass: r stages from s0 on (..., 2^r) points of segment l."""
    big_r = 1 << r
    for b in range(r):
        h = 1 << (r - 1 - b)
        for j in range(big_r):
            if j & h:
                continue
            w = tab[(1 << (s0 + b)) - 1 + l + (_brev(j >> (r - b), b) << s0)]
            u, x = pts[..., j].copy(), pts[..., j + h] * w
            pts[..., j] = u + x
            pts[..., j + h] = u - x


class _Exchange:
    """Two exchange buffers of a CTA (cap complex points each), addressed
    through the swizzle; NaN until written."""

    def __init__(self, cap):
        self.buf = [np.full(cap, np.nan + 0j), np.full(cap, np.nan + 0j)]

    def load(self, p):
        def ld(idx):
            v = self.buf[p % 2][_swizzle(idx)]
            assert not np.isnan(v).any(), "a pass read a point no pass wrote"
            return v
        return ld

    def store(self, p):
        def st(idx, v):
            self.buf[p % 2][_swizzle(idx)] = v
        return st


def _round_trip(n, load, middle, store, twf, twi):
    """regs_round_trip: the forward passes, the merged pass (``middle(x)``:
    the forward's last pass's registers (nt, 2^lg, RS) -> the inverse's
    first pass's inputs, slot j' holding bin j' 2^lg + q), the inverse
    passes; pass p writes exchange buffer p mod 2."""
    _, rs_pts, rs, lg, _, nt = _layout(n)
    fwd, inv = gk.regs_pass_plan(n)
    ex = _Exchange(nt * n)
    src, p = load, 0
    for s0, r in fwd[:-1]:
        idx, l = _read_idx(n, nt, s0, r)
        pts = src(idx)
        _stages(pts, s0, r, twf, l)
        ex.store(p)(_write_idx(n, nt, r), pts)
        src, p = ex.load(p), p + 1
    s0, r = fwd[-1]
    idx, l = _read_idx(n, nt, s0, r)
    x = src(idx)
    _stages(x, s0, r, twf, l)
    y = middle(x)
    _stages(y, 0, rs, twi, np.zeros((nt, 1 << lg), np.int64))
    dst = store if len(inv) == 1 else ex.store(p)
    dst(_write_idx(n, nt, rs), y)
    src, p = ex.load(p), p + 1
    for k, (s0, r) in enumerate(inv[1:]):
        idx, l = _read_idx(n, nt, s0, r)
        pts = src(idx)
        _stages(pts, s0, r, twi, l)
        last = k == len(inv) - 2
        (store if last else ex.store(p))(_write_idx(n, nt, r), pts)
        src, p = ex.load(p), p + 1


def _to_inverse_slots(x, rs):
    """Inverse's first pass slot j' <- forward's last pass slot brev(j')."""
    return x[..., _brev_np(np.arange(1 << rs), rs)]


# ---------------------------------------------------------------------------
# the model of the body
# ---------------------------------------------------------------------------

def body_model(u, floor, h, nfft, hop, release=0.0, threshold_db=6.0, reduction_db=60.0,
               window_kind="hann", tail=None, n_valid=None):
    """asp::fir_gate_regs in float64 on the FIR input u (C, n): returns the
    output (C, nfft + (F-1) hop) and each frame's mask decisions (C, F,
    nfft/2+1), |A| > floor * gain, checked equal wherever a frame is
    computed twice (the halo).  ``h`` None: the gate alone (kFir false, the
    span only the tile's frames, gate_geometry's tiles).  ``n_valid``: one
    time shard (asp::shard_geo): the first n_valid frames of u (C, l + d),
    the un-normalized output of length l + d (no 1/WOLA table), 0 past the
    last frame's end.  The output starts NaN, and every position must be
    written exactly once."""
    n_ch, n = u.shape
    fir = h is not None
    big_n, hp, taps = nfft, hop, len(h) if fir else 1
    _, rs_pts, rs, lg, _, nt = _layout(big_n)
    nb, d, r = big_n // 2 + 1, big_n - hp, big_n // hp
    nframes = 1 + (n - big_n) // hp if n_valid is None else n_valid
    out_len = big_n + (nframes - 1) * hp if n_valid is None else n
    frames_end = big_n + (nframes - 1) * hp if nframes else 0
    seq = release > 0.0
    geo = gk.regs_geometry(big_n, hp, taps, seq, tail, fir)
    mf, blk, nfb = geo["mf"], big_n - (taps - 1), 2 * nt
    tile = mf * hp
    ntiles = -(-out_len // tile)
    twf = fk.stockham_stage_table_np(big_n, -1.0)
    twi = fk.stockham_stage_table_np(big_n, 1.0)
    hf = np.fft.fft(np.concatenate([h, np.zeros(big_n - taps)])) if fir else None if fir else None
    win = window_np(window_kind, big_n, periodic=True)
    inv_tab = _inv_norm_table(win, big_n, hp)
    gain, att = 10.0 ** (threshold_db / 20.0), 10.0 ** (-reduction_db / 20.0)
    pairs = _bin_pairs(big_n)
    ka = np.minimum(pairs[:, 5], big_n - pairs[:, 5])

    def inv_norm(gp):
        if n_valid is not None:  # a null table
            return np.ones(len(gp))
        return np.where(gp < d, inv_tab[np.minimum(gp, max(d - 1, 0))],
                        np.where(gp >= out_len - d, inv_tab[np.clip(d + hp + gp - (out_len - d), 0,
                                                                    len(inv_tab) - 1)],
                                 inv_tab[d + gp % hp]))

    out = np.full((n_ch, out_len), np.nan)
    written = np.zeros((n_ch, out_len), np.int64)
    dec = np.full((n_ch, nframes, nb), -1, np.int64)
    for c in range(n_ch):
        thr = floor[c] * gain
        rel = np.zeros(nb)
        carry = np.zeros(d)
        for j in range(ntiles):
            ts = j * tile
            qa = max(0, j * mf - (0 if seq else r - 1))
            qb = min((j + 1) * mf, nframes)
            lo, hi = (0, out_len) if seq else (ts, min(ts + tile, out_len))
            if not seq:
                carry = np.zeros(d)
            zero = np.arange(max(ts, frames_end), min(ts + tile, out_len))
            out[c, zero] = 0.0
            written[c, zero] += 1
            if qb <= qa:
                # a shard's tiles past its frames; the sequential walker's
                # last tile where it is shorter than a frame's spill (nfft 8192)
                assert n_valid is not None or seq, "a parallel tile without frames"
                continue
            y0 = qa * hp
            length = (qb - 1) * hp + big_n - y0
            nblk = -(-length // blk) if fir else 0
            s = y0 - (taps - 1)
            span = np.zeros(nblk * blk + taps - 1 if fir else length)
            src = np.arange(s, s + len(span))
            ok = (src >= 0) & (src < n)
            span[ok] = u[c, src[ok]]
            assert len(span) <= geo["span"]
            # ---- FIR batches, in place (none for the gate alone)
            for k0 in range(0, nblk, nfb):
                def load(idx, k0=k0):
                    t, i = idx // big_n, idx % big_n
                    kb = k0 + 2 * t
                    re = np.where(kb < nblk, span[np.minimum(kb * blk + i, len(span) - 1)], 0.0)
                    im = np.where(kb + 1 < nblk,
                                  span[np.minimum((kb + 1) * blk + i, len(span) - 1)], 0.0)
                    return re + 1j * im

                def middle(x):
                    q = np.arange(1 << lg)[None, :, None]
                    bins = (_brev_np(np.arange(rs_pts), rs) << lg) + q
                    return _to_inverse_slots(x * hf[bins], rs)

                writes = []

                def store(idx, v, k0=k0):
                    writes.append((idx, v, k0))

                _round_trip(big_n, load, middle, store, twf, twi)
                for idx, v, kk0 in writes:  # after every read of the batch
                    t, i = idx // big_n, idx % big_n
                    o = i - (taps - 1)
                    kb = kk0 + 2 * t
                    for part, kbb in ((v.real, kb), (v.imag, kb + 1)):
                        sel = (o >= 0) & (kbb < nblk)
                        span[(kbb * blk + o)[sel]] = part[sel] / big_n
            # ---- gate batches and overlap-add
            for q0 in range(qa, qb, nfb):
                nf = min(nfb, qb - q0)
                has_a = 2 * np.arange(nt) < nf
                has_b = 2 * np.arange(nt) + 1 < nf

                def load(idx, q0=q0):
                    t, i = idx // big_n, idx % big_n
                    base = (q0 - qa + 2 * t) * hp + i
                    re = np.where(has_a[t], span[np.minimum(base, len(span) - 1)] * win[i], 0.0)
                    im = np.where(has_b[t], span[np.minimum(base + hp, len(span) - 1)] * win[i],
                                  0.0)
                    return re + 1j * im

                def middle(x, q0=q0, nf=nf):
                    nonlocal rel
                    zk = x[:, pairs[:, 1], pairs[:, 2]]
                    zn = x[:, pairs[:, 3], pairs[:, 4]]
                    a = 0.5 * (zk + np.conj(zn))
                    b = -0.5j * (zk - np.conj(zn))
                    th = thr[ka]
                    ma = np.where(np.abs(a) > th, 1.0, att)
                    mb = np.where(np.abs(b) > th, 1.0, att)
                    for t in range(nt):  # the decisions of each frame, once per bin
                        for f, m in ((2 * t, ma[t]), (2 * t + 1, mb[t])):
                            if f < nf:
                                got = dec[c, q0 + f, ka]
                                new = (m == 1.0).astype(np.int64)
                                assert ((got == -1) | (got == new)).all()
                                dec[c, q0 + f, ka] = new
                    if seq:  # raw masks to the batch's buffer, the scan, back
                        masks = np.full((nfb, nb), np.nan)
                        for t in range(nt):
                            if has_a[t]:
                                masks[2 * t, ka] = ma[t]
                            if has_b[t]:
                                masks[2 * t + 1, ka] = mb[t]
                        for f in range(nf):
                            rel = np.maximum(masks[f], release * rel)
                            masks[f] = rel
                        ma, mb = masks[0::2][:, ka], masks[1::2][:, ka]
                    ma = np.where(has_a[:, None], ma, 0.0)
                    mb = np.where(has_b[:, None], mb, 0.0)
                    yk = ma * a + 1j * mb * b
                    yn = ma * np.conj(a) + 1j * mb * np.conj(b)
                    x = x.copy()
                    x[:, pairs[:, 1], pairs[:, 2]] = yk
                    x[:, pairs[:, 3], pairs[:, 4]] = yn
                    return _to_inverse_slots(x, rs)

                stage = np.full(nt * big_n, np.nan + 0j)

                def store(idx, v):
                    stage[idx] = v * (win[idx % big_n] / big_n)

                _round_trip(big_n, load, middle, store, twf, twi)
                fin = nf * hp
                p = np.arange(fin + d)
                v = np.concatenate([carry, np.zeros(fin)])
                for f in range(nf):
                    fr = stage[(f >> 1) * big_n: (f >> 1) * big_n + big_n]
                    v[f * hp: f * hp + big_n] += fr.imag if f & 1 else fr.real
                end = q0 + nf == nframes
                final = (p < fin) | end
                gp = q0 * hp + p
                emit = final & (gp >= lo) & (gp < hi)
                out[c, gp[emit]] = v[emit] * inv_norm(gp[emit])
                written[c, gp[emit]] += 1
                carry = v[fin:]
    assert (written == 1).all(), "an output position was written twice or never"
    assert not np.isnan(out).any()
    assert (dec >= 0).all()
    return out, dec


def _plain_decisions(y, floor, nfft, hop, threshold_db=6.0):
    mag = stft(torch.as_tensor(y), nfft, hop, impl="torch").abs().numpy()
    return (mag > floor[:, None, :] * 10.0 ** (threshold_db / 20.0)).astype(np.int64)


def _tone_burst(rng, c, n, fs=48000):
    t = np.arange(n) / fs
    x = 0.01 * rng.standard_normal((c, n))
    x += np.where((t > 0.25 * n / fs) & (t < 0.7 * n / fs), np.sin(2 * np.pi * 440.0 * t), 0.0)
    return x


def _frames_for(nfft, hop, taps, release, tiles, fir=True):
    """An odd frame count giving one tile (the fewest frames the guards
    allow), or three or more."""
    mf = gk.regs_geometry(nfft, hop, taps, release > 0.0, fir=fir)["mf"]
    if tiles == 1:
        nfr = max(2 * (nfft // hop) - 2, NOISE_FRAMES) | 1
        assert nfft + (nfr - 1) * hop <= mf * hop
        return nfr
    return 2 * mf + 1


def _run_chain(nfft, hop, taps, release, tiles, seed):
    rng = np.random.default_rng(seed)
    nfr = _frames_for(nfft, hop, taps, release, tiles)
    nfr = max(nfr, NOISE_FRAMES, -(-2 * (nfft - hop) // hop))
    n = nfft + (nfr - 1) * hop + hop // 2  # a partial hop past the last frame
    x = _tone_burst(rng, 2, n)
    h = design_fir(taps, 0.3) if taps > 1 else np.ones(1)
    xt = torch.as_tensor(x)
    win_t = torch.as_tensor(window_np("hann", nfft, periodic=True))
    head = xt[:, : min(n, nfft - hop + NOISE_FRAMES * hop + nfft)]
    floor = ck.filtered_floor(head, h, nfft, hop, NOISE_FRAMES, win_t).numpy()
    got, dec = body_model(x, floor, h, nfft, hop, release)
    ref = ck.fir_noise_gate_ref(xt, h, nfft, hop, noise_frames=NOISE_FRAMES,
                                release=release).numpy()
    y = overlap_save(xt, h, nfft, impl="torch").numpy()
    return got, ref, dec, _plain_decisions(y, floor, nfft, hop)


CASES = [(nfft, nfft // div, taps, release)
         for nfft in (256, 512, 1024, 2048) for div in (2, 4, 8)
         for taps in (1, 30, 64, 384) for release in (0.0, 0.6) if taps - 1 < nfft]


@pytest.mark.parametrize("nfft,hop,taps,release", CASES)
def test_model_is_the_plain_chain(nfft, hop, taps, release):
    """The body's model, on a tone burst over three or more tiles (an odd
    frame count), against fir_noise_gate_ref in float64: >= 200 dB, the
    same mask decision at every frame and bin, each output position written
    once."""
    got, ref, dec, want = _run_chain(nfft, hop, taps, release, 3, 7 + nfft + hop + taps)
    assert got.shape == ref.shape
    assert np.array_equal(dec, want)
    assert _snr(ref, got) >= 200.0


@pytest.mark.parametrize("nfft,hop,release", [
    (256, 64, 0.0), (256, 64, 0.6), (512, 128, 0.0), (512, 128, 0.6), (1024, 256, 0.0),
    (1024, 256, 0.6), (2048, 256, 0.6), (2048, 512, 0.6),
])
def test_model_one_tile(nfft, hop, release):
    """A file of one tile (the halo clamped at frame 0, the last frame's
    spill written by the same batch); at nfft 2048 only the sequential
    walker's tile holds the shortest file the guards allow."""
    got, ref, dec, want = _run_chain(nfft, hop, 64, release, 1, 3 + nfft)
    assert np.array_equal(dec, want)
    assert _snr(ref, got) >= 200.0


@pytest.mark.parametrize("nfft,hop", [(2, 1), (4, 2), (8, 2), (16, 4), (32, 8), (64, 16),
                                      (128, 32), (4096, 1024)])
def test_model_small_and_large_nfft(nfft, hop):
    """The one-pass transforms (nfft <= 16, the FIR's loads held before its
    stores), the two-pass plans, and the plan of four passes at 4096."""
    rng = np.random.default_rng(nfft)
    nfr = max(2 * (nfft // hop) + 3, 9) | 1
    n = nfft + (nfr - 1) * hop
    x = rng.standard_normal((1, n))
    taps = min(nfft - 1, 9) | 1
    h = design_fir(taps, 0.3) if taps > 1 else np.array([0.7])
    xt = torch.as_tensor(x)
    win_t = torch.as_tensor(window_np("hann", nfft, periodic=True))
    floor = ck.filtered_floor(xt[:, : min(n, nfft - hop + 4 * hop + nfft)], h, nfft, hop, 4,
                              win_t).numpy()
    for release in (0.0, 0.6):
        got, dec = body_model(x, floor, h, nfft, hop, release)
        ref = ck.fir_noise_gate_ref(xt, h, nfft, hop, noise_frames=4, release=release).numpy()
        y = overlap_save(xt, h, nfft, impl="torch").numpy()
        assert np.array_equal(dec, _plain_decisions(y, floor, nfft, hop))
        assert _snr(ref, got) >= 200.0


@pytest.mark.parametrize("up,down,taps,release", [(160, 147, 64, 0.0), (160, 147, 64, 0.6),
                                                  (2, 1, 96, 0.7), (147, 160, 384, 0.0)])
def test_model_is_the_plain_resampling_chain(up, down, taps, release):
    """The resampling kernel's body: the model on the causal polyphase
    resample of the file (what its fill stages) against
    resample_fir_gate_ref in float64, with its own geometry (the phase bank
    and raw window in the tail)."""
    rng = np.random.default_rng(up + taps)
    nfft, hop = 1024, 256
    up_r, down_r, h_res = reduce_ratio(up, down, None)
    nk = taps_per_phase(len(h_res), up_r)
    tail = lambda span: up_r * nk + rk.res_window(span, up_r, down_r, nk)  # noqa: E731
    mf = gk.regs_geometry(nfft, hop, taps, release > 0.0, tail)["mf"]
    n_res = nfft + 2 * mf * hop + 333
    n = -(-n_res * down // up)
    x = _tone_burst(rng, 2, n, fs=44100)
    h = design_fir(taps, 0.2 if taps == 384 else 0.25)
    xt = torch.as_tensor(x)
    u = resample_poly(xt, up, down, zero_phase=False)
    win_t = torch.as_tensor(window_np("hann", nfft, periodic=True))
    need = nfft - hop + 8 * hop
    head = resample_poly(xt[:, : min(n, -(-need * down // up) + 1)], up, down,
                         zero_phase=False)
    floor = ck.filtered_floor(head, h, nfft, hop, 8, win_t).numpy()
    got, dec = body_model(u.numpy(), floor, h, nfft, hop, release, tail=tail)
    ref = rk.resample_fir_gate_ref(xt, up, down, h, release=release).numpy()
    y = overlap_save(u, h, nfft, impl="torch").numpy()
    assert np.array_equal(dec, _plain_decisions(y, floor, nfft, hop))
    assert _snr(ref, got) >= 200.0


# ---------------------------------------------------------------------------
# the gate alone (noise_gate_fused) and one time shard of it (gate_shard_fused)
# ---------------------------------------------------------------------------

def _gate_floor(x, nfft, hop):
    """noise_gate_fused's prologue: the floor of the first NOISE_FRAMES frames."""
    w = torch.as_tensor(window_np("hann", nfft, periodic=True))
    head = torch.as_tensor(x)[:, : nfft - hop + NOISE_FRAMES * hop]
    return gk.noise_floor(frame(head, nfft, hop) * w).numpy()


def _run_gate(nfft, hop, release, tiles, seed):
    rng = np.random.default_rng(seed)
    nfr = _frames_for(nfft, hop, 1, release, tiles, fir=False)
    nfr = max(nfr, NOISE_FRAMES, -(-2 * (nfft - hop) // hop))
    n = nfft + (nfr - 1) * hop + hop // 2  # a partial hop past the last frame
    x = _tone_burst(rng, 2, n)
    floor = _gate_floor(x, nfft, hop)
    got, dec = body_model(x, floor, None, nfft, hop, release)
    ref = gk.noise_gate_ref(torch.as_tensor(x), nfft, hop, noise_frames=NOISE_FRAMES,
                            release=release).numpy()
    return got, ref, dec, _plain_decisions(x, floor, nfft, hop)


def _one_gate_tile(nfft, hop, release):
    """Whether gate_geometry's tile holds the shortest file the guards allow."""
    nfr = max(2 * (nfft // hop) - 2, NOISE_FRAMES) | 1
    return nfft + (nfr - 1) * hop <= gk.gate_geometry(nfft, hop, release > 0.0)["mf"] * hop


GATE_CASES = [(nfft, nfft // div, release, tiles)
              for nfft in (256, 512, 1024, 2048, 4096) for div in (2, 4, 8)
              for release in (0.0, 0.6) for tiles in (1, 3)
              if tiles > 1 or _one_gate_tile(nfft, nfft // div, release)]


@pytest.mark.parametrize("nfft,hop,release,tiles", GATE_CASES)
def test_gate_model_is_the_plain_gate(nfft, hop, release, tiles):
    """The body without its FIR (kFir false: the span holds the tile's raw
    frames) on gate_geometry's tiles, on a tone burst of one tile or three
    and more (an odd frame count), against noise_gate_ref in float64:
    >= 200 dB, the same mask decision at every frame and bin, each output
    position written once."""
    got, ref, dec, want = _run_gate(nfft, hop, release, tiles, 11 + nfft + hop + tiles)
    assert got.shape == ref.shape
    assert np.array_equal(dec, want)
    assert _snr(ref, got) >= 200.0


def _run_shard(nfft, hop, l_hops, n_valid, seed):
    rng = np.random.default_rng(seed)
    x_ext = _tone_burst(rng, 2, l_hops * hop + nfft - hop)
    floor = _gate_floor(x_ext, nfft, hop)
    got, dec = body_model(x_ext, floor, None, nfft, hop, n_valid=n_valid)
    ref = gk.gate_shard_ref(torch.as_tensor(x_ext), torch.as_tensor(floor), n_valid, nfft,
                            hop).numpy()
    want = _plain_decisions(x_ext[:, : (n_valid - 1) * hop + nfft], floor, nfft, hop)[
        :, :n_valid] if n_valid else dec
    return got, ref, dec, want


def _shard_cases():
    """(nfft, hop, l/hop, n_valid): shards of one tile and of several (an odd
    count of hops), with no frame, one, an odd count below l/hop, and all."""
    cases = []
    for nfft in (256, 512, 1024, 2048, 4096):
        for div in (2, 4, 8):
            hop = nfft // div
            mf = gk.gate_geometry(nfft, hop, False)["mf"]
            for l_hops in (div + 1, 2 * mf + 5):
                for n_valid in sorted({0, 1, (l_hops // 2) | 1, l_hops}):
                    cases.append((nfft, hop, l_hops, n_valid))
    return cases


@pytest.mark.parametrize("nfft,hop,l_hops,n_valid", _shard_cases())
def test_shard_model_is_the_plain_shard(nfft, hop, l_hops, n_valid):
    """One time shard (asp::shard_geo): the body on the shard's l samples and
    its right neighbour's first d, the first n_valid frames only, a null
    1/WOLA table (the un-normalized overlap-add) and an output of l + d
    samples, 0 from the last frame's end on, against gate_shard_ref in
    float64: >= 200 dB, the same decisions, every position of the
    NaN-filled output written once (the spill and the zero tail too)."""
    got, ref, dec, want = _run_shard(nfft, hop, l_hops, n_valid, 5 + nfft + l_hops + n_valid)
    d = nfft - hop
    assert got.shape == ref.shape == (2, l_hops * hop + d)
    assert np.array_equal(dec, want)
    end = (n_valid - 1) * hop + nfft if n_valid else 0
    assert not got[:, end:].any()
    assert _snr(ref, got) >= 200.0


def test_gate_headline_geometry():
    """The gate alone at nfft 1024, hop 256: a span of the tile's frames
    only (no FIR blocks or history), so the parallel tile grows to 29 hops
    (32 frames, four batches of 8) at 2 CTAs an SM (a third does not fit:
    the two exchange buffers alone take 64 KB); the sequential walker's
    tile is the largest of the weighed ones (128 hops, 16 batches)."""
    geo = gk.gate_geometry(1024, 256, False)
    assert geo == gk.regs_geometry(1024, 256, 1, False, fir=False)
    assert geo["mf"] == 29 and (geo["mf"] + 3) % 8 == 0
    assert geo["span"] == (29 + 3 - 1) * 256 + 1024 == gk.regs_span(1024, 256, 1, 29, False,
                                                                     fir=False)
    assert geo["smem"] == gk.regs_smem(1024, 256, 1, 29, False, fir=False) == 111624
    assert 2 * (geo["smem"] + 1024) <= gk.SM_SMEM < 3 * (geo["smem"] + 1024)
    seq = gk.gate_geometry(1024, 256, True)
    assert seq["mf"] == 128 and seq["smem"] <= SMEM_LIMIT
    # gate_geometry sizes its span from the frames alone; the chain's, with
    # one tap, still rounds it to whole overlap-save blocks
    assert gk.regs_span(1024, 256, 1, 21, False) == 7 * 1024 > gk.regs_span(
        1024, 256, 1, 21, False, fir=False)


def test_gate_model_at_the_headline_geometry():
    """The model at gate_geometry's headline tile (29 hops, within
    SMEM_LIMIT at 2 CTAs an SM), whole file and a middle shard of the
    sharded gate's width (468 hops)."""
    assert gk.gate_geometry(1024, 256, False)["smem"] <= SMEM_LIMIT
    got, ref, dec, want = _run_gate(1024, 256, 0.0, 3, 29)
    assert np.array_equal(dec, want) and _snr(ref, got) >= 200.0
    got, ref, dec, want = _run_shard(1024, 256, 468, 468, 30)
    assert np.array_equal(dec, want) and _snr(ref, got) >= 200.0


# ---------------------------------------------------------------------------
# the slot identity and the mirror pairs, every plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", PLAN_SIZES)
def test_slot_identity_and_mirror_pairs(n):
    """The forward passes leave bin brev(j) 2^lg + q in slot j of group q
    (checked against np.fft on random rows, every transform of a batch);
    the inverse's first pass (stage 0) reads bin j' 2^lg + q in its slot
    j', which is the forward's slot brev(j'); for_bin_pairs visits each
    (group, slot) of a transform once, pairing bin k with n - k."""
    big_r, rs_pts, rs, lg, g_threads, nt = _layout(n)
    rng = np.random.default_rng(n)
    data = rng.standard_normal((nt, n)) + 1j * rng.standard_normal((nt, n))
    fwd, _ = gk.regs_pass_plan(n)
    twf = fk.stockham_stage_table_np(n, -1.0)
    flat = data.reshape(-1)
    src, ex = (lambda idx: flat[idx]), _Exchange(nt * n)
    for p, (s0, r) in enumerate(fwd[:-1]):
        idx, l = _read_idx(n, nt, s0, r)
        pts = src(idx)
        _stages(pts, s0, r, twf, l)
        ex.store(p)(_write_idx(n, nt, r), pts)
        src = ex.load(p)
    s0, r = fwd[-1]
    idx, l = _read_idx(n, nt, s0, r)
    x = src(idx)
    _stages(x, s0, r, twf, l)
    q = np.arange(1 << lg)[:, None]
    bins = (_brev_np(np.arange(rs_pts), rs) << lg) + q
    spec = np.fft.fft(data, axis=-1)
    np.testing.assert_allclose(x, spec[:, bins], rtol=0, atol=1e-9 * n)
    inv_idx, _ = _read_idx(n, nt, 0, rs)
    assert np.array_equal(inv_idx % n, np.broadcast_to(_to_inverse_slots(bins, rs), inv_idx.shape))
    pairs = _bin_pairs(n)
    seen = np.zeros((1 << lg, rs_pts), np.int64)
    for u_, qa, ja, qb, jb, k in pairs:
        assert bins[qa, ja] == k and bins[qb, jb] == (n - k) % n
        seen[qa, ja] += 1
        if (qa, ja) != (qb, jb):
            seen[qb, jb] += 1
        else:
            assert k in (0, n // 2)
    assert (seen == 1).all()
    # the units of a transform share its threads evenly: kUnits = 8 / RS a
    # thread (one where the transform is one group)
    units = 1 if lg == 0 else 1 << (lg - 1)
    assert set(pairs[:, 0]) == set(range(units))
    assert units == (1 if big_r == rs_pts else 8 // rs_pts) * g_threads


@pytest.mark.parametrize("n", PLAN_SIZES)
def test_plan_is_the_real_kernels_plan(n):
    """The forward runs rfft_stockham's passes of its n-point half-size
    transform and the inverse irfft_stockham's: every stage once, the
    merged pass (the forward's last, the inverse's first) of 1 to 3 stages
    from 32 points on, so a pair of groups holds at most 16 points; an odd
    number of passes a round trip (the stage is not the buffer the last
    pass reads)."""
    fwd, inv = gk.regs_pass_plan(n)
    big_l = n.bit_length() - 1
    for plan in (fwd, inv):
        assert [s for s0, r in plan for s in range(s0, s0 + r)] == list(range(big_l))
    assert fwd[-1][1] == inv[0][1]
    assert [r for _, r in inv] == [fwd[-1][1]] + [r for _, r in fwd[:-1]]
    if n >= 32:
        assert 1 <= fwd[-1][1] <= 3
    assert (len(fwd) + len(inv) - 1) % 2 == 1
    if n == 1024:
        assert fwd == [(0, 4), (4, 4), (8, 2)] and inv == [(0, 2), (2, 4), (6, 4)]


# ---------------------------------------------------------------------------
# the exchange's banks
# ---------------------------------------------------------------------------

def _exchange_accesses(n, gate, mirrors_only=False, no_mirrors=False):
    """Every warp access of the exchange in a round trip, as batch-local
    indices, one row of 32 lanes per access: each pass's loads of slot j
    and stores of slot j (the first pass's loads from the span and the last
    pass's stores to the span or the stage left out).  The team (``Team``):
    from 512 points transform t's N/16 threads, lane i taking its groups i
    + N/16 k; below, the CTA, thread i taking groups i + 256 k of the batch
    (group v: transform v >> lg, group v mod 2^lg); in the gate's merged
    pass the same over units (transform w >> lu, unit w mod 2^lu: groups u
    and its mirror, unit 0 groups 0 and 2^(lg-1))."""
    big_r, rs_pts, rs, lg, g_threads, nt = _layout(n)
    fwd, inv = gk.regs_pass_plan(n)
    big_l = n.bit_length() - 1
    tid = np.arange(THREADS).reshape(-1, 32)
    if g_threads >= 32:  # first index of the team's items, lane, team size
        size = g_threads
        team, lane = tid // size, tid % size
    else:
        size, team, lane = THREADS, np.zeros_like(tid), tid
    per_team = 1 if g_threads >= 32 else nt  # transforms a team
    rows = []

    def reads(t, groups, s0, r):
        lgp = big_l - r
        pw = lgp - s0
        l, p = groups >> pw, groups & ((1 << pw) - 1)
        base = t * n + (l << (big_l - s0)) + p
        return [base + (j << pw) for j in range(1 << r)]

    def writes(t, groups, r):
        lgp = big_l - r
        return [t * n + groups + (_brev(j, r) << lgp) for j in range(1 << r)]

    passes = [("f", s0, r) for s0, r in fwd[:-1]] + [("m", fwd[-1][0], rs)] + [
        ("i", s0, r) for s0, r in inv[1:]]
    for k, (kind, s0, r) in enumerate(passes):
        first, last = k == 0, k == len(passes) - 1
        lgp = big_l - r
        tg = []  # (transform, group) of each lane, one entry per load/store instruction
        if kind == "m" and gate:
            lu = max(lg - 1, 0)
            for i in range(max(1, per_team * (1 << lu) // size)):
                w = ((team * per_team) << lu) + lane + i * size
                t, u = w >> lu, w & ((1 << lu) - 1)
                if not mirrors_only:
                    tg.append((t, u))
                if lg > 0 and not no_mirrors:
                    tg.append((t, np.where(u == 0, 1 << (lg - 1), (1 << lg) - u)))
        else:
            for i in range(max(1, per_team * (1 << lgp) // size)):
                v = ((team * per_team) << lgp) + lane + i * size
                if not mirrors_only:
                    tg.append((v >> lgp, v & ((1 << lgp) - 1)))
        for t, gq in tg:
            if not first:
                rows += reads(t, gq, s0, r)
            if not last:
                rows += writes(t, gq, r)
    return np.array(rows).reshape(-1, 32) if rows else np.zeros((0, 32), np.int64)


def _ways(idx):
    return max(np.bincount(row & 31, minlength=32).max() for row in idx)


@pytest.mark.parametrize("n", [1 << k for k in range(5, 13)])
@pytest.mark.parametrize("gate", (False, True), ids=("fir", "gate"))
def test_exchange_banks(n, gate):
    """Under pease_swizzle each warp access of every pass to the exchange
    touches 32 distinct banks (4-byte planes), at every n from 32 (the
    first with an exchange) to 4096, except in the gate's merged pass: a
    warp's 32 units take aligned groups u, whose mirrors 2^lg - u are 32
    consecutive groups one off the alignment, so those accesses meet 2
    ways (below 256 points, where a warp spans several transforms, the
    units' own groups too); the FIR's merged pass has no mirror.  Without
    the swizzle the strided reads collide from 64 on."""
    def ways(acc):
        return np.array([np.bincount(row & 31, minlength=32).max() for row in _swizzle(acc)])

    own = ways(_exchange_accesses(n, gate, no_mirrors=True))
    mirror = ways(_exchange_accesses(n, gate, mirrors_only=True))
    if not gate:
        assert len(mirror) == 0 and (own == 1).all()
    else:
        assert len(mirror) > 0 and mirror.max() == 2
        assert own.max() == (1 if n >= 256 else 2)
        # each warp's loads and stores of its 8 mirror points a thread
        assert len(mirror) == THREADS // 32 * 16
    if n >= 64:
        assert _ways(_exchange_accesses(n, gate)) > 1


# ---------------------------------------------------------------------------
# the geometry
# ---------------------------------------------------------------------------

def test_headline_geometry():
    """At nfft 1024, hop 256, 64 taps the parallel tile is 21 hops (24
    frames: three gate batches of 8, one FIR batch of 8 blocks) in 106788
    bytes, two CTAs an SM; the sequential walker takes 56 (7 batches)."""
    geo = gk.regs_geometry(1024, 256, 64)
    assert geo["mf"] == 21 and (geo["mf"] + 3) % 8 == 0
    assert geo["smem"] == gk.regs_smem(1024, 256, 64, 21, False) == 106788
    assert 2 * (geo["smem"] + 1024) <= gk.SM_SMEM
    assert gk.regs_geometry(1024, 256, 64, True)["mf"] % 8 == 0
    assert gk.regs_batch(1024) == 4 and gk.regs_batch(4096) == 1 and gk.regs_batch(8) == 256


@pytest.mark.parametrize("release", (0.0, 0.6))
def test_config5_geometry_fits(release):
    """Both kernels at config 5 (160/147, 3201 resampler taps, 64 FIR
    taps): within SMEM_LIMIT at the same tile; in the parallel launch the
    phase bank and raw window fit inside the tail (the exchange buffers),
    so the resampling kernel takes the 48 kHz kernel's shared memory (the
    sequential walker's longer span needs a larger tail)."""
    up, down = 160, 147
    h_res = resample_filter(up, down)
    assert len(h_res) == 3201
    nk = taps_per_phase(len(h_res), up)
    geo = rk.res_geometry(up, down, nk, 1024, 256, 64, release > 0.0)
    base = gk.regs_geometry(1024, 256, 64, release > 0.0)
    assert geo["smem"] <= SMEM_LIMIT and geo["mf"] == base["mf"]
    if release == 0.0:  # the bank and raw window fit in the exchange buffers
        assert geo == base
        assert up * nk + rk.res_window(geo["span"], up, down, nk) <= 4 * THREADS * 16


def _old_accepts(nfft, hop, taps):
    """Whether the retired radix-2 tile body's geometry fitted SMEM_LIMIT
    (its formula, frozen here): twiddles (nfft/2 complex), FFT buffer (nfft
    complex), threshold and release state (nfft/2+1 each), OLA tile (tile +
    nfft-hop), FIR span (tile + 2 (nfft-hop) in whole overlap-save blocks,
    plus the history); tiles of max(16, nfft/hop) hops."""
    d = nfft - hop
    tile = max(16, nfft // hop) * hop
    blk = nfft - (taps - 1)
    span = -(-(tile + 2 * d) // blk) * blk + taps - 1
    nb = nfft // 2 + 1
    return 8 * (nfft // 2) + 8 * nfft + 4 * (2 * nb + tile + d + span) <= SMEM_LIMIT


@pytest.mark.parametrize("nfft", [1 << k for k in range(1, 14)])
def test_every_old_geometry_is_accepted(nfft):
    """Every (nfft, hop, taps) the radix-2 body's geometry fitted in
    SMEM_LIMIT (nfft 2 to 4096) has a batched geometry within it whose
    tile frames fill whole batches; the rest raise a ValueError naming
    SMEM_LIMIT."""
    for hop in [nfft >> k for k in range(0, 13) if nfft >> k >= 1]:
        for taps in sorted({1, 2, min(64, nfft), nfft // 2 + 1, nfft}):
            for seq in (False, True):
                if not _old_accepts(nfft, hop, taps):
                    continue
                geo = gk.regs_geometry(nfft, hop, taps, seq)
                halo = 0 if seq else nfft // hop - 1
                assert geo["smem"] <= SMEM_LIMIT and geo["mf"] >= 1
                assert (geo["mf"] + halo) % (2 * gk.regs_batch(nfft)) == 0
                assert geo["span"] == gk.regs_span(nfft, hop, taps, geo["mf"], seq)
    if nfft == 8192:  # one transform of 512 threads and one exchange buffer
        geo = gk.regs_geometry(8192, 2048, 64)
        assert geo["smem"] <= SMEM_LIMIT and gk.regs_batch(8192) == 1
        with pytest.raises(ValueError, match="SMEM_LIMIT"):
            gk.regs_geometry(16384, 4096, 64)


@pytest.mark.parametrize("nfft", [1 << k for k in range(1, 14)])
def test_every_old_gate_geometry_still_launches(nfft):
    """Every (nfft, hop, release) whose noise_gate_fused or gate_shard_fused
    the radix-2 body launched (its gate-alone geometry, one tap, within
    SMEM_LIMIT: nfft 2 to 4096, and at 4096 only hop <= 512) has a
    gate_geometry, the one both wrappers launch with, within SMEM_LIMIT
    whose tile frames fill whole batches; nfft 8192 was never launched."""
    hops = [nfft >> k for k in range(0, 13) if nfft >> k >= 1]
    old = [hop for hop in hops if _old_accepts(nfft, hop, 1)]
    if nfft >= 4096:
        assert old == [h for h in hops if nfft == 4096 and h <= 512]
    for hop in old:
        for seq in (False, True):
            geo = gk.gate_geometry(nfft, hop, seq)
            halo = 0 if seq else nfft // hop - 1
            assert geo["smem"] <= SMEM_LIMIT and geo["mf"] >= 1
            assert (geo["mf"] + halo) % (2 * gk.regs_batch(nfft)) == 0
            assert geo["span"] == gk.regs_span(nfft, hop, 1, geo["mf"], seq, fir=False)


def test_gate_tables_hold_the_stockham_tables():
    """The wrappers hand both kernels the window, the tap spectrum, the
    forward and inverse per-stage tables (stockham_table(nfft, -1), (nfft,
    +1)) in place of the radix-2 twiddles, and the 1/WOLA table."""
    dev = torch.device("cpu")
    h = design_fir(64, 0.3)
    win, hf, twf, twi, inv_tab = ck.gate_tables(h.tobytes(), 1024, 256, "hann", dev)
    assert torch.equal(twf, fk.stockham_table(1024, -1, dev))
    assert torch.equal(twi, fk.stockham_table(1024, 1, dev))
    assert hf.shape == (2 * 1024,) and win.shape == (1024,)
    assert inv_tab.shape == (2 * (1024 - 256) + 256,)


def test_chip_smoke_reads_both_kernels_ptxas():
    """chip_smoke's phases 5, 13 and 14 report each instantiation <R, RS,
    release> of the three kernels on the batched body from nvcc's ptxas
    log, each kernel's own (the resampling kernel's name holds the
    others', the 48 kHz one's the gate's)."""
    import chip_smoke

    entry = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{n}{name}"
             "ILi16ELi{rs}ELb{rel}EEEvPKf' for 'sm_90a'\n"
             "    8 bytes stack frame, {sp} bytes spill stores, {sp} bytes spill loads\n"
             "ptxas info    : Used {regs} registers, used 1 barriers\n")
    log = (entry.format(n=21, name="fir_noise_gate_kernel", rs=4, rel=0, sp=8, regs=128)
           + entry.format(n=25, name="res_fir_noise_gate_kernel", rs=2, rel=1, sp=0, regs=120)
           + entry.format(n=17, name="noise_gate_kernel", rs=2, rel=0, sp=0, regs=96)
           + "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117gate_step_kernelEv'"
             " for 'sm_90a'\nptxas info    : Used 30 registers\n")
    assert (chip_smoke.chain_ptxas(log, "fir_noise_gate_kernel")
            == "<16,4,0> 128 registers 8 bytes spill stores")
    assert (chip_smoke.chain_ptxas(log, "res_fir_noise_gate_kernel")
            == "<16,2,1> 120 registers 0 bytes spill stores")
    assert (chip_smoke.chain_ptxas(log, "noise_gate_kernel")
            == "<16,2,0> 96 registers 0 bytes spill stores")
    assert chip_smoke.chain_ptxas("", "noise_gate_kernel") == "not built in this process"


def test_chip_smoke_reads_the_thread_count_instantiations():
    """chip_smoke's ptxas reader on the instantiations templated on their
    thread count: the whole-file kernels' <R, RS, release, T> read as before
    at 256 threads and with their T at 512 (nfft 8192); the step kernels'
    <R, RS, T> (the release is read at run time, the CTAs a channel follow
    from T), each by name (the resampling one's name holds the other's, the
    FIR one's the gate step's)."""
    import chip_smoke

    whole = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121fir_noise_gate_kernel"
             "ILi16ELi2ELb{rel}ELi{t}EEEvPKf' for 'sm_90a'\n"
             "    0 bytes stack frame, {sp} bytes spill stores, {sp} bytes spill loads\n"
             "ptxas info    : Used {regs} registers, used 16 barriers\n")
    step = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{n}{name}"
            "ILi16ELi{rs}ELi{t}EEEvN3asp12GateStepArgsE' for 'sm_90a'\n"
            "    0 bytes stack frame, {sp} bytes spill stores, {sp} bytes spill loads\n"
            "ptxas info    : Used {regs} registers, used 16 barriers\n")
    log = (whole.format(rel=0, t=256, sp=0, regs=128) + whole.format(rel=1, t=512, sp=480,
                                                                     regs=128)
           + step.format(n=20, name="fir_gate_step_kernel", rs=4, t=256, sp=0, regs=248)
           + step.format(n=20, name="fir_gate_step_kernel", rs=2, t=512, sp=572, regs=128)
           + step.format(n=24, name="res_fir_gate_step_kernel", rs=4, t=256, sp=0, regs=219)
           + step.format(n=16, name="gate_step_kernel", rs=4, t=256, sp=0, regs=200)
           + step.format(n=16, name="gate_step_kernel", rs=2, t=512, sp=16, regs=128)
           + step.format(n=19, name="stretch_step_kernel", rs=4, t=256, sp=0, regs=190))
    assert (chip_smoke.chain_ptxas(log, "fir_noise_gate_kernel")
            == "<16,2,0> 128 registers 0 bytes spill stores; "
               "<16,2,1,512> 128 registers 480 bytes spill stores")
    assert (chip_smoke.chain_ptxas(log, "fir_gate_step_kernel")
            == "<16,4,256> 248 registers 0 bytes spill stores; "
               "<16,2,512> 128 registers 572 bytes spill stores")
    assert (chip_smoke.chain_ptxas(log, "res_fir_gate_step_kernel")
            == "<16,4,256> 219 registers 0 bytes spill stores")
    assert (chip_smoke.chain_ptxas(log, "gate_step_kernel")
            == "<16,4,256> 200 registers 0 bytes spill stores; "
               "<16,2,512> 128 registers 16 bytes spill stores")
    assert (chip_smoke.chain_ptxas(log, "stretch_step_kernel")
            == "<16,4,256> 190 registers 0 bytes spill stores")


def test_chip_smoke_unexplained_hops_follow_the_pairing():
    """chip_smoke's rule for the sharded gate against the whole file, on
    the geometry both launches take (gate_geometry: 29-hop tiles, 3 halo
    frames).  With one shard the launches are the same, so a hop is
    explained only where a covering frame is transformed alone (the odd
    last frame of a tile); shard 0 of four pairs its frames as the whole
    file does below its last tile; the first hop of shard 1 (frame 468
    with 469 from the shard's own origin, with 467 in the whole file's
    tile from frame 461) is explained."""
    import chip_smoke

    n, lh, frames = 479232, 468, 1869
    hops = list(range(n // 256))
    one = chip_smoke.unexplained_hops(hops, n, 1)
    for g in set(hops) - set(one):
        assert any(chip_smoke.gate_partner(k, g, 29, 4, frames) is None
                   for k in range(max(0, g - 3), min(g, frames - 1) + 1))
    assert 28 not in one and 27 in one  # tile 0: frames 0 to 28, frame 28 alone
    assert len(one) > 0.8 * len(hops)
    assert chip_smoke.gate_partner(468 - lh, 0, 29, 4, 468) == 1
    assert chip_smoke.gate_partner(468, 468, 29, 4, frames) == 467
    four = chip_smoke.unexplained_hops(hops, n, 4)
    assert set(one) & set(range(16 * 29)) <= set(four)
    assert lh not in four and lh in one


# ---------------------------------------------------------------------------
# nfft 8192: one transform a batch, one exchange buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("release", (0.0, 0.6))
def test_regs_geometry_at_nfft_8192(release):
    """At nfft 8192, hop 2048 a batch is one transform of 512 threads of 16
    points with one exchange buffer (64 KB), no masks buffer (the release
    scan of a batch's two frames runs in registers) and the span in device
    memory, and the gate, its shard, the chain (64 taps) and the
    resampler's tail (config 5's bank and raw window) fit SMEM_LIMIT; the
    parallel and sequential launches both, one CTA an SM, the gate and the
    chain with tiles as long as at nfft 1024."""
    seq = release > 0.0
    assert gk.regs_threads(8192) == 512 and gk.regs_one_buffer(8192)
    assert gk.regs_batch(8192) == 1 and not gk.regs_one_buffer(4096)
    up, down = 160, 147
    nk = taps_per_phase(len(resample_filter(up, down)), up)
    geos = [gk.gate_geometry(8192, 2048, seq), gk.regs_geometry(8192, 2048, 64, seq),
            rk.res_geometry(up, down, nk, 8192, 2048, 64, seq)]
    if not seq:
        geos.append(gk.gate_geometry(8192, 2048, False))  # the shard's launch
    for geo in geos:
        assert geo["smem"] <= SMEM_LIMIT < 2 * (geo["smem"] + 1024)
        assert geo["mf"] >= 1 and (geo["mf"] + (0 if seq else 3)) % 2 == 0
    # the chain without release: 147464 bytes (thresholds 32776, carries
    # 49152, one buffer 65536), 31 hops a tile; its span of 81353 floats a
    # CTA in device memory, a row per (channel, tile)
    assert gk.regs_geometry(8192, 2048, 64)["smem"] == 147464
    assert gk.regs_smem(8192, 2048, 64, 1, False) == 4 * (2 * 4097 + 2 * 6144 + 16384)
    assert gk.gate_geometry(8192, 2048, False)["mf"] == 31
    assert gk.regs_geometry(8192, 2048, 64)["mf"] == 31
    assert gk.regs_span_rows(4096, 1024, geos[0], 3, 10 ** 5, seq, "cpu") is None
    rows = gk.regs_span_rows(8192, 2048, geos[1], 3, 8192 + 99 * 2048, seq, "cpu")
    ntiles = 1 if seq else -(-(8192 + 99 * 2048) // (geos[1]["mf"] * 2048))
    assert rows.shape == (3 * ntiles, geos[1]["span"])


@pytest.mark.parametrize("nfft", (16384, 32768))
def test_regs_geometry_raises_past_8192(nfft):
    """Past nfft 8192 one transform needs more shared memory per block than
    SMEM_LIMIT: every whole-file geometry and the step body's raise a
    ValueError naming it."""
    up, down = 160, 147
    nk = taps_per_phase(len(resample_filter(up, down)), up)
    for fn in (lambda: gk.gate_geometry(nfft, nfft // 4, False),
               lambda: gk.gate_geometry(nfft, nfft // 4, True),
               lambda: gk.regs_geometry(nfft, nfft // 4, 64),
               lambda: rk.res_geometry(up, down, nk, nfft, nfft // 4, 64),
               lambda: ck.step_regs_geometry(nfft, nfft // 4, 64, 0, 2 * nfft, 8)):
        with pytest.raises(ValueError, match="SMEM_LIMIT"):
            fn()


@pytest.mark.parametrize("release", (0.0, 0.6))
def test_model_at_nfft_8192(release):
    """The body's model at nfft 8192, hop 2048 (one transform a batch, two
    frames): the gate alone and the chain (64 taps) against the plain
    versions in float64, >= 200 dB, every decision equal."""
    rng = np.random.default_rng(81)
    n = 8192 + 13 * 2048 + 77
    x = _tone_burst(rng, 1, n)
    floor = _gate_floor(x, 8192, 2048)
    got, dec = body_model(x, floor, None, 8192, 2048, release)
    ref = gk.noise_gate_ref(torch.as_tensor(x), 8192, 2048, noise_frames=NOISE_FRAMES,
                            release=release).numpy()
    assert np.array_equal(dec, _plain_decisions(x, floor, 8192, 2048))
    assert _snr(ref, got) >= 200.0
    h = design_fir(64, 0.3)
    xt = torch.as_tensor(x)
    win_t = torch.as_tensor(window_np("hann", 8192, periodic=True))
    floor = ck.filtered_floor(xt[:, : 8192 - 2048 + NOISE_FRAMES * 2048 + 8192], h, 8192, 2048,
                              NOISE_FRAMES, win_t).numpy()
    got, dec = body_model(x, floor, h, 8192, 2048, release)
    ref = ck.fir_noise_gate_ref(xt, h, 8192, 2048, noise_frames=NOISE_FRAMES,
                                release=release).numpy()
    y = overlap_save(xt, h, 8192, impl="torch").numpy()
    assert np.array_equal(dec, _plain_decisions(y, floor, 8192, 2048))
    assert _snr(ref, got) >= 200.0


# ---------------------------------------------------------------------------
# the streaming step body (csrc/fir_gate_step_regs.cuh)
# ---------------------------------------------------------------------------

def _forward(n, load, twf):
    """regs_forward: the forward passes of a batch; the merged last pass's
    registers (nt, 2^lg, RS) after its stages (slot j of group q: bin
    brev(j) 2^lg + q)."""
    _, _, _, _, _, nt = _layout(n)
    fwd, _ = gk.regs_pass_plan(n)
    ex = _Exchange(nt * n)
    src = load
    for p, (s0, r) in enumerate(fwd[:-1]):
        idx, l = _read_idx(n, nt, s0, r)
        pts = src(idx)
        _stages(pts, s0, r, twf, l)
        ex.store(p)(_write_idx(n, nt, r), pts)
        src = ex.load(p)
    s0, r = fwd[-1]
    idx, l = _read_idx(n, nt, s0, r)
    x = src(idx)
    _stages(x, s0, r, twf, l)
    return x


def _inverse(n, y, store, twi):
    """regs_inverse: the inverse's first pass on y (nt, 2^lg, RS; slot j'
    holding bin j' 2^lg + q), the inverse passes, the last through store."""
    _, _, rs, lg, _, nt = _layout(n)
    _, inv = gk.regs_pass_plan(n)
    ex = _Exchange(nt * n)
    y = y.copy()
    _stages(y, 0, rs, twi, np.zeros((nt, 1 << lg), np.int64))
    (store if len(inv) == 1 else ex.store(0))(_write_idx(n, nt, rs), y)
    src = ex.load(0)
    for k, (s0, r) in enumerate(inv[1:]):
        idx, l = _read_idx(n, nt, s0, r)
        pts = src(idx)
        _stages(pts, s0, r, twi, l)
        last = k == len(inv) - 2
        (store if last else ex.store(k + 1))(_write_idx(n, nt, r), pts)
        src = ex.load(k + 1)


def _frame_intervals(pos, floor_n, m, d, hop, nf, input_latency, eof_in):
    """The kernel's valid [jv0, jv1) and floor [jv0, jt1) new frames, from
    the scalars."""
    start0 = pos - d
    jv0 = max(0, -((start0 - input_latency) // hop))
    jv1 = m if eof_in is None else min(m, (eof_in - (d + hop) - start0) // hop + 1)
    jv1 = max(jv1, jv0)
    return jv0, jv1, min(jv1, jv0 + max(0, nf - floor_n))


def step_model(x, state, h, *, nfft, hop, threshold_db, reduction_db, noise_frames, release,
               window_kind, input_latency, latency, env_h=None, env_scale=np.pi / 2.0,
               eof_in=None, fs=None, cluster=1):
    """asp::fir_gate_step_regs in float64: one block x (C, b) with the plain
    step's carry [FIR history, gate dict, envelope history], the signature
    of fir_gate_step_ref; with ``h`` None the kFir false schedule of the
    gate step (the gate dict alone, gate_step_ref's signature: no FIR
    batches, the span [in_tail | x] of the segment's frames).  Segments of
    ``fs`` new frames (step_regs_geometry's unless given), the FIR batches
    in place on the segment's span, analysis batches of 2B frames (the
    spectra to the FIFO or the pop buffer, |X| to the floor in frame
    order), synthesis batches from the popped spectra (the release scan
    per bin along the batch), the overlap-add pass (each position once,
    the carry), the envelope over the rectified row.  ``cluster`` 2: two
    CTAs, each with its own frames (``step_split``) and segments; the
    first CTA's takes add to the floor, the second's to a part of its own,
    added after.  Every output position and carry is written once
    (NaN-filled)."""
    xn = x.numpy()
    n_ch, b = xn.shape
    big_n, hp, nf = nfft, hop, noise_frames
    _, rs_pts, rs, lg, _, nt = _layout(big_n)
    nb, d, r, m = big_n // 2 + 1, big_n - hp, big_n // hp, b // hp
    fir = h is not None
    taps = len(h) if fir else 0
    hl, blk, nfb = max(taps - 1, 0), big_n - max(taps - 1, 0), 2 * nt
    te = 0 if env_h is None else len(env_h)
    ehl = max(te - 1, 0)
    if fs is None:
        fs = ck.step_regs_geometry(big_n, hp, taps, te, b, nf, None, cluster)["fs"]
    assert fs % nfb == 0
    split = ck.step_split(m, big_n, cluster)
    segments = [(j0, min(hi, j0 + fs)) for lo, hi in ((0, split), (split, m))
                for j0 in range(lo, hi, fs)]
    twf = fk.stockham_stage_table_np(big_n, -1.0)
    twi = fk.stockham_stage_table_np(big_n, 1.0)
    hf = np.fft.fft(np.concatenate([h, np.zeros(big_n - taps)])) if fir else None
    win, head, const, tail = gk._step_tables_np(big_n, hp, window_kind)
    gain, att = 10.0 ** (threshold_db / 20.0), 10.0 ** (-reduction_db / 20.0)
    pairs = _bin_pairs(big_n)
    hi = 2 * pairs[:, 5] > big_n
    kk = np.where(hi, big_n - pairs[:, 5], pairs[:, 5])
    g = state[1] if fir else state
    pos, floor_n = g["pos"], g["floor_n"]
    jv0, jv1, jt1 = _frame_intervals(pos, floor_n, m, d, hp, nf, input_latency, eof_in)
    valid, take, eof_out = gk.gate_step_masks(pos, floor_n, m, d, hp, nf, input_latency, eof_in)
    assert [jv0 <= j < jv1 for j in range(m)] == valid
    assert [jv0 <= j < jt1 for j in range(m)] == take
    p0 = pos - latency - input_latency

    def inv_norm(p):
        v = np.where(p < 0, 1.0, np.where(p < d, 1.0 / head[np.clip(p, 0, max(d - 1, 0))],
                                          1.0 / const))
        if eof_out is not None:
            ti = np.clip(p - (eof_out - d), 0, max(d - 1, 0))
            v = np.where(p >= eof_out, 1.0, np.where(p >= eof_out - d, 1.0 / tail[ti], v))
        return v

    np_ = lambda t: t.numpy().reshape(n_ch, -1).copy() if t.numel() else np.zeros((n_ch, 0))
    hist = np_(state[0]) if fir else np.zeros((n_ch, 0))
    ehist = np_(state[2]) if te else None
    fifo_r, fifo_i = g["fifo_r"].numpy(), g["fifo_i"].numpy()
    new_fr, new_fi = np.full_like(fifo_r, np.nan), np.full_like(fifo_i, np.nan)
    out = np.full((n_ch, b), np.nan)
    written = np.zeros((n_ch, b), np.int64)
    new = dict(in_tail=np.full((n_ch, d), np.nan), ola_tail=np.full((n_ch, d), np.nan),
               floor_sum=np.full((n_ch, 1, nb), np.nan), hist=np.full((n_ch, hl), np.nan))
    if release > 0.0:
        new["rel"] = np.full((n_ch, 1, nb), np.nan)
    for c in range(n_ch):
        u = np.concatenate([hist[c], xn[c], np.zeros(big_n + blk)])  # u[s] at s + hl
        fsum = g["floor_sum"].numpy()[c, 0].copy()
        rel = g["rel"].numpy()[c, 0].copy() if release > 0.0 else np.zeros(nb)
        carry = g["ola_tail"].numpy()[c].copy()
        new_fr[c, : max(nf - m, 0)] = fifo_r[c, m:]
        new_fi[c, : max(nf - m, 0)] = fifo_i[c, m:]
        pop = np.full((max(m - nf, 0), nb), np.nan + 0j)
        rect = np.concatenate([ehist[c], np.full(b, np.nan)]) if te else None
        fpart = np.zeros(nb)  # the second CTA's takes
        # ---- FIR and analysis, segment by segment
        for j0, j1 in segments:
            e0 = j0 * hp
            tl = max(0, d - e0)
            seg = (j1 - j0 - 1) * hp + big_n
            y0 = max(0, e0 - d)
            nblk = -(-(seg - tl) // blk) if fir else 0
            if fir:
                fsp = u[y0: y0 + nblk * blk + hl].copy()  # u[y0 - hl + i]
            else:  # the fill: x[e0 + tl - d + i] for i < seg - tl
                fsp = xn[c, e0 + tl - d: e0 - d + seg].copy()
                assert len(fsp) == seg - tl
            if j1 == m and fir:
                new["hist"][c] = fsp[b - y0: b - y0 + hl]
            for k0 in range(0, nblk, nfb):
                def load(idx, k0=k0):
                    t, i = idx // big_n, idx % big_n
                    kb = k0 + 2 * t
                    re = np.where(kb < nblk, fsp[np.minimum(kb * blk + i, len(fsp) - 1)], 0.0)
                    im = np.where(kb + 1 < nblk,
                                  fsp[np.minimum((kb + 1) * blk + i, len(fsp) - 1)], 0.0)
                    return re + 1j * im

                def middle(x_):
                    q = np.arange(1 << lg)[None, :, None]
                    bins = (_brev_np(np.arange(rs_pts), rs) << lg) + q
                    return _to_inverse_slots(x_ * hf[bins], rs)

                writes = []
                _round_trip(big_n, load, middle, lambda idx, v: writes.append((idx, v)), twf,
                            twi)
                for idx, v in writes:
                    t, i = idx // big_n, idx % big_n
                    o = i - hl
                    for part, kbb in ((v.real, k0 + 2 * t), (v.imag, k0 + 2 * t + 1)):
                        sel = (o >= 0) & (kbb < nblk)
                        fsp[(kbb * blk + o)[sel]] = part[sel] / big_n
            span = np.concatenate([g["in_tail"].numpy()[c, e0: e0 + tl], fsp])
            if j1 == m:
                new["in_tail"][c] = span[b - e0: b - e0 + d]
            for q0 in range(j0, j1, nfb):
                nfr = min(nfb, j1 - q0)

                def load(idx, q0=q0, nfr=nfr):
                    t, i = idx // big_n, idx % big_n
                    fa = 2 * t
                    base = (q0 - j0 + fa) * hp + i
                    ok_a = (fa < nfr) & (q0 + fa >= jv0) & (q0 + fa < jv1)
                    ok_b = (fa + 1 < nfr) & (q0 + fa + 1 >= jv0) & (q0 + fa + 1 < jv1)
                    re = np.where(ok_a, span[np.minimum(base, len(span) - 1)] * win[i], 0.0)
                    im = np.where(ok_b, span[np.minimum(base + hp, len(span) - 1)] * win[i], 0.0)
                    return re + 1j * im

                z = _forward(big_n, load, twf)
                zk = z[:, pairs[:, 1], pairs[:, 2]]
                zn = z[:, pairs[:, 3], pairs[:, 4]]
                p_, q_ = np.where(hi, zn, zk), np.where(hi, zk, zn)
                a_ = 0.5 * (p_ + np.conj(q_))
                b_ = -0.5j * (p_ - np.conj(q_))
                mags = np.full((nfb, nb), np.nan)
                for t in range(nt):
                    for fa, spec in ((2 * t, a_[t]), (2 * t + 1, b_[t])):
                        if fa >= nfr:
                            continue
                        fq = q0 + fa
                        mags[fa, kk] = np.abs(spec)
                        v = nf + fq
                        if v >= m:
                            new_fr[c, v - m, kk], new_fi[c, v - m, kk] = spec.real, spec.imag
                        else:
                            pop[fq, kk] = spec
                for fa in range(nfr):  # the floor, frame by frame in order
                    if jv0 <= q0 + fa < jt1:
                        if q0 + fa < split:
                            fsum = fsum + mags[fa]
                        else:
                            fpart = fpart + mags[fa]
        if jt1 > jv0 and split < m:
            fsum = fsum + fpart
        # ---- synthesis
        thr = fsum / nf * gain

        def popped(q):
            return fifo_r[c, q] + 1j * fifo_i[c, q] if q < nf else pop[q - nf]

        for q0 in range(0, m, nfb):
            nfr = min(nfb, m - q0)
            masks = np.zeros((nfb, nb))
            for fa in range(nfr):
                masks[fa] = np.where(np.abs(popped(q0 + fa)) > thr, 1.0, att)
                if release > 0.0:
                    rel = np.maximum(masks[fa], release * rel)
                    masks[fa] = rel
            xz = np.full((nt, 1 << lg, rs_pts), np.nan + 0j)
            for t in range(nt):
                pa = popped(q0 + 2 * t)[kk] if 2 * t < nfr else np.zeros(len(kk))
                pb = popped(q0 + 2 * t + 1)[kk] if 2 * t + 1 < nfr else np.zeros(len(kk))
                edge = (kk == 0) | (2 * kk == big_n)
                ya = np.where(edge, pa.real, pa) * masks[2 * t, kk]
                yb = np.where(edge, pb.real, pb) * masks[2 * t + 1, kk]
                ya, yb = np.where(hi, np.conj(ya), ya), np.where(hi, np.conj(yb), yb)
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
            e = v[:fin] * inv_norm(p0 + gp)
            if te:
                rect[ehl + gp] = np.abs(e)
            else:
                out[c, gp] = e
            written[c, gp] += 1
            carry = v[fin:]
        new["ola_tail"][c] = carry
        new["floor_sum"][c, 0] = fsum
        if release > 0.0:
            new["rel"][c, 0] = rel
        if te:
            hr = np.asarray(env_h, np.float64)[::-1]
            out[c] = env_scale * np.array([hr @ rect[o: o + te] for o in range(b)])
            ehist[c] = rect[b: b + ehl]
    assert (written == 1).all() and not np.isnan(out).any()
    for v in list(new.values()) + [new_fr, new_fi]:
        assert not np.isnan(v).any(), "a carry position was never written"
    shape = lambda a, ref: torch.as_tensor(a).reshape(ref.shape)
    gate = dict(in_tail=shape(new["in_tail"], g["in_tail"]),
                fifo_r=shape(new_fr, g["fifo_r"]), fifo_i=shape(new_fi, g["fifo_i"]),
                floor_sum=shape(new["floor_sum"], g["floor_sum"]),
                floor_n=floor_n + sum(take), ola_tail=shape(new["ola_tail"], g["ola_tail"]),
                pos=pos + b)
    if release > 0.0:
        gate["rel"] = shape(new["rel"], g["rel"])
    if not fir:
        return gate, torch.as_tensor(out).reshape(x.shape)
    st = [shape(new["hist"], state[0]), gate]
    if te:
        st.append(shape(ehist, state[2]))
    return st, torch.as_tensor(out).reshape(x.shape)


def _assert_carries_equal(got, ref):
    for a, b_ in zip(_flat_carry(got), _flat_carry(ref)):
        if isinstance(b_, torch.Tensor):
            assert a.shape == b_.shape
            np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-9, atol=1e-11)
        else:
            assert a == b_


def _flat_carry(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _flat_carry(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _flat_carry(t)]
    return [tree]


STEP_CASES = [  # (nfft, hop, block, taps, env taps, release, drain, noise frames, fs)
    (1024, 256, 4096, 64, 0, 0.0, False, 8, None),       # the headline: 16 frames, 2 batches
    (1024, 256, 4096, 64, 129, 0.6, True, 8, None),      # the envelope, a drained stream
    (1024, 256, 5 * 256, 64, 0, 0.6, False, 8, None),    # m odd, below nf: a partial batch
    (1024, 256, 13 * 256, 30, 17, 0.6, True, 4, None),   # m odd, above nf and 2B
    (1024, 256, 20 * 256, 64, 0, 0.6, False, 4, 8),      # segments of 8 frames, release across
    (512, 128, 3 * 128, 1, 1, 0.0, False, 4, None),      # m < 2B, one tap each
    (256, 64, 37 * 64, 64, 0, 0.6, True, 8, None),       # a warp spans transforms
    (2048, 512, 7 * 512, 500, 0, 0.0, False, 4, None),   # a long FIR, three blocks a batch
    (4096, 1024, 5 * 1024, 64, 0, 0.6, False, 4, 2),     # one transform, in_tail over segments
]


def _step_stream(monkeypatch, chain, x, block, drain, fs, name="fir_gate_step_ref",
                 cluster=1):
    """chain.stream in float64 with the model in place of the plain step;
    each block also checked against the plain step on the same carry."""
    from audiosignalprocess_tpu_torch import pipeline

    plain = getattr(pipeline, name)

    def model_step(*args, **kw):
        # the stage hands the plain gate step its impl: the model's
        # transforms are the kernel's, the plain step's follow impl
        plain_kw = dict(kw)
        kw.pop("impl", None)
        if name == "res_fir_gate_step_ref":
            xb, st, up, down, h_fir, h_res = args
            u = resample_poly(xb, up, down, h=h_res, zero_phase=False, history=st[0])
            hn = st[0].shape[-1]
            res_hist = torch.cat([st[0], xb], dim=-1)[..., -hn:] if hn else st[0]
            fg, y = step_model(u, st[1], h_fir, fs=fs, cluster=cluster, **kw)
        elif name == "gate_step_ref":
            xb, st = args
            new, y = step_model(xb, st, None, fs=fs, cluster=cluster, **kw)
        else:
            xb, st, h_fir = args
            new, y = step_model(xb, st, h_fir, fs=fs, cluster=cluster, **kw)
        want_st, want_y = plain(*args, **plain_kw)
        if float(want_y.abs().max()) > 0.0:
            assert _snr(want_y.numpy(), y.numpy()) >= 200.0
        else:  # a block inside the latency: silence
            assert float(y.abs().max()) < 1e-12
        if name == "res_fir_gate_step_ref":
            new = [res_hist, fg]
        _assert_carries_equal(new, want_st)
        return new, y

    monkeypatch.setattr(pipeline, name, model_step)
    y = chain.stream(x, block, drain=drain).numpy()
    monkeypatch.setattr(pipeline, name, plain)
    return y


@pytest.mark.parametrize("cluster", (1, 2))
@pytest.mark.parametrize("nfft,hop,block,taps,env_taps,release,drain,nf,fs", STEP_CASES)
def test_step_model_is_the_plain_step(monkeypatch, nfft, hop, block, taps, env_taps, release,
                                      drain, nf, fs, cluster):
    """The step body's model, one CTA (the schedule of nfft 8192, here at
    the smaller sizes) or a cluster of two per channel, stepped through a
    stream of FIRGateStage in place of fir_gate_step_ref: each block's
    output >= 200 dB and every carry equal (to rounding) against the plain
    step on the same carry, and the stream against the plain stream; every
    output and carry position written once (NaN-filled)."""
    from audiosignalprocess_tpu_torch.pipeline import Chain, FIRGateStage

    rng = np.random.default_rng(nfft + block + taps)
    n = max(6 * block, 10 * nfft) // block * block + (777 if drain else 0)
    x = torch.as_tensor(_tone_burst(rng, 2, n))
    h = design_fir(taps, 0.3) if taps > 1 else np.array([0.8])
    env_h = None if not env_taps else (design_fir(env_taps, 0.01) if env_taps > 1
                                       else np.array([0.5]))
    chain = Chain([FIRGateStage(h=h, nfft=nfft, hop=hop, noise_frames=nf, release=release,
                                env_h=env_h)])
    chain.build()
    got = _step_stream(monkeypatch, chain, x, block, drain, fs, cluster=cluster)
    ref = chain.stream(x, block, drain=drain).numpy()
    assert _snr(ref, got) >= 200.0


@pytest.mark.parametrize("cluster", (1, 2))
@pytest.mark.parametrize("block,release,drain,env_taps", [(4704, 0.0, False, 0),
                                                         (3 * 1176, 0.6, True, 129)])
def test_step_model_is_the_plain_resampling_step(monkeypatch, block, release, drain, env_taps,
                                                 cluster):
    """The resampling kernel's step: the model on the causal polyphase
    resample of [res_hist | x] (what its fill resamples into the span) in
    place of res_fir_gate_step_ref, 20 and 15 resampled hops a block:
    >= 200 dB and every carry equal, block by block and as a stream."""
    from audiosignalprocess_tpu_torch.pipeline import Chain, ResFIRGateStage

    rng = np.random.default_rng(block)
    n = 8 * block + (555 if drain else 0)
    x = torch.as_tensor(_tone_burst(rng, 2, n, fs=44100))
    chain = Chain([ResFIRGateStage(h=design_fir(64, 0.3), noise_frames=4, release=release,
                                   env_h=design_fir(env_taps, 0.01) if env_taps else None)])
    chain.build()
    got = _step_stream(monkeypatch, chain, x, block, drain, None, "res_fir_gate_step_ref",
                       cluster)
    ref = chain.stream(x, block, drain=drain).numpy()
    assert _snr(ref, got) >= 200.0


@pytest.mark.parametrize("release,block", [(0.0, 2048), (0.6, 5 * 256)])
def test_step_model_is_the_jax_plain_step(monkeypatch, release, block):
    """The model's float64 stream against the JAX package's FIRGateStage
    float64 stream (its plain step) on the same input: allclose at the
    port's float64 tolerance."""
    from audiosignalprocess_tpu import pipeline as J
    import jax.numpy as jnp

    from audiosignalprocess_tpu_torch.pipeline import Chain, FIRGateStage

    rng = np.random.default_rng(block)
    x = _tone_burst(rng, 2, 8 * block)
    h = design_fir(64, 0.3)
    kw = dict(h=h, nfft=1024, hop=256, noise_frames=4, release=release)
    jc, pc = J.Chain([J.FIRGateStage(**kw)]), Chain([FIRGateStage(**kw)])
    assert jc.build() == pc.build()
    got = _step_stream(monkeypatch, pc, torch.as_tensor(x), block, False, None)
    want = np.asarray(jc.stream(jnp.asarray(x), block))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


GATE_STEP_CASES = [  # (nfft, hop, block, release, drain, noise frames, fs)
    (1024, 256, 4096, 0.0, False, 8, None),    # the headline: 16 frames, a batch a CTA
    (1024, 256, 5 * 256, 0.6, True, 8, None),   # m odd, below nf: a partial batch
    (1024, 256, 9 * 256, 0.6, False, 4, None),  # the second CTA with one frame
    (1024, 256, 20 * 256, 0.6, False, 4, 8),    # segments of 8 frames, release across
    (256, 64, 37 * 64, 0.0, True, 8, None),     # a warp spans transforms
    (16, 4, 3 * 4, 0.6, False, 4, None),        # one pass each way, m < 2B
    (4096, 1024, 5 * 1024, 0.6, True, 4, 2),    # one transform, in_tail over segments
]


@pytest.mark.parametrize("cluster", (1, 2))
@pytest.mark.parametrize("nfft,hop,block,release,drain,nf,fs", GATE_STEP_CASES)
def test_step_model_is_the_plain_gate_step(monkeypatch, nfft, hop, block, release, drain, nf,
                                           fs, cluster):
    """The gate step's schedule (the step body with kFir false: no FIR
    batches, the span [in_tail | x] of a segment's frames), one CTA or a
    cluster of two per channel, stepped through a GateStage stream in place
    of gate_step_ref: each block >= 200 dB and every carry equal (to
    rounding) against the plain step on the same carry, the stream against
    the plain stream; every output and carry position written once."""
    from audiosignalprocess_tpu_torch.pipeline import Chain, GateStage

    rng = np.random.default_rng(nfft + block + 1)
    n = max(6 * block, 10 * nfft) // block * block + (777 if drain else 0)
    x = torch.as_tensor(_tone_burst(rng, 2, n))
    chain = Chain([GateStage(nfft=nfft, hop=hop, noise_frames=nf, release=release)])
    chain.build()
    got = _step_stream(monkeypatch, chain, x, block, drain, fs, "gate_step_ref", cluster)
    ref = chain.stream(x, block, drain=drain).numpy()
    assert _snr(ref, got) >= 200.0


@pytest.mark.parametrize("cluster", (1, 2))
@pytest.mark.parametrize("release,block,drain", [(0.0, 2048, False), (0.6, 9 * 256, True)])
def test_gate_step_model_is_the_jax_plain_step(monkeypatch, release, block, drain, cluster):
    """The gate step's model, float64 stream, against the JAX package's
    GateStage float64 stream (its plain step) on the same input: allclose
    at the port's float64 tolerance."""
    from audiosignalprocess_tpu import pipeline as J
    import jax.numpy as jnp

    from audiosignalprocess_tpu_torch.pipeline import Chain, GateStage

    rng = np.random.default_rng(block + 3)
    x = _tone_burst(rng, 2, 8 * block + (555 if drain else 0))
    kw = dict(nfft=1024, hop=256, noise_frames=4, release=release)
    jc, pc = J.Chain([J.GateStage(**kw)]), Chain([GateStage(**kw)])
    assert jc.build() == pc.build()
    got = _step_stream(monkeypatch, pc, torch.as_tensor(x), block, drain, None, "gate_step_ref",
                       cluster)
    want = np.asarray(jc.stream(jnp.asarray(x), block, drain=drain))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_step_geometry_fits_every_launch():
    """step_regs_geometry within SMEM_LIMIT, segments of whole batches, for
    every shape the card tests and chip_smoke give the two step kernels; at
    the headline (64 taps, 16 or 20 new frames, the envelope of 129 taps or
    none) the whole block is one segment with the popped spectra and the
    envelope's input in shared memory (one CTA an SM)."""
    up, down = 160, 147
    nk = taps_per_phase(len(resample_filter(up, down)), up)
    fir_shapes = [(1024, 256, 4096, t, e) for t in (1, 64, 500) for e in (0, 1, 129, 300)] + [
        (256, 64, 320, 64, 129), (512, 128, 33 * 128, 64, 0), (1024, 256, 768, 64, 0),
        (1024, 256, 21 * 256, 64, 129), (1024, 256, 257 * 256, 64, 3000),
        (2048, 512, 7 * 512, 500, 300), (4096, 1024, 5 * 1024, 64, 129),
        (4096, 512, 9 * 512, 64, 0), (8192, 2048, 3 * 2048, 64, 129),
        (8192, 2048, 5 * 2048, 64, 0), (8192, 1024, 9 * 1024, 1, 0), (1024, 256, 2048, 64, 129)]
    res_shapes = [(1024, 256, b, e) for b in (1280, 2560, 3840, 5120) for e in (0, 129)] + [
        (256, 64, 320, 129), (2048, 512, 2560, 129), (4096, 1024, 5120, 129),
        (8192, 2048, 10240, 129), (8192, 2048, 10240, 0)]
    shapes = [(nf, hp, b, t, e, None) for nf, hp, b, t, e in fir_shapes] + [
        (nf, hp, b, 64, e, (up, down, nk)) for nf, hp, b, e in res_shapes]
    for nfft, hop, b, taps, te, res in shapes:
        for nf in (4, 8):
            cluster = ck.step_cluster(nfft)
            geo = ck.step_regs_geometry(nfft, hop, taps, te, b, nf, res, cluster)
            assert geo["smem"] <= SMEM_LIMIT and geo["cluster"] == cluster
            assert geo["fs"] % (2 * gk.regs_batch(nfft)) == 0
    assert ck.step_cluster(8192) == 1 and ck.step_cluster(4096) == 2
    for b, res in ((4096, None), (5120, (up, down, nk))):
        for te in (0, 129):
            geo = ck.step_regs_geometry(1024, 256, 64, te, b, 8, res, ck.step_cluster(1024))
            split = ck.step_split(b // 256, 1024, ck.step_cluster(1024))
            assert geo["fs"] >= split and geo["pop_smem"] and (geo["rect_smem"] or not te)
            assert gk.SM_SMEM < 2 * (geo["smem"] + 1024)
    assert [ck.step_split(m, 1024, 2) for m in (3, 8, 9, 16, 20, 24)] == [3, 8, 8, 8, 16, 16]
    # the gate step (taps 0: no FIR): the card tests' grid and the headline
    gate_shapes = [(4, 1, 3), (4, 1, 600), (8, 2, 5), (16, 4, 1031), (32, 8, 129), (64, 16, 9),
                   (256, 64, 33), (512, 128, 17), (1024, 256, 16), (1024, 256, 257),
                   (2048, 512, 7), (4096, 1024, 2), (4096, 512, 5), (8192, 2048, 3),
                   (8192, 2048, 16), (8192, 1024, 9)]
    for nfft, hop, m in gate_shapes:
        for nf in (4, 8):
            cluster = ck.step_cluster(nfft)
            geo = ck.step_regs_geometry(nfft, hop, 0, 0, m * hop, nf, None, cluster)
            assert geo["smem"] <= SMEM_LIMIT and not geo["rect_smem"]
            assert geo["fs"] % (2 * gk.regs_batch(nfft)) == 0
    geo = ck.step_regs_geometry(1024, 256, 0, 0, 4096, 8, None, 2)
    assert geo["fs"] >= ck.step_split(16, 1024, 2) and geo["pop_smem"]
    assert geo["smem"] == 138348 and gk.SM_SMEM < 2 * (geo["smem"] + 1024)


@pytest.mark.parametrize("nfft,hop,m,fs", [(1024, 256, 16, 8), (1024, 256, 20, 8),
                                           (256, 64, 37, 32), (4096, 1024, 5, 2)])
def test_step_span_without_fir(nfft, hop, m, fs):
    """step_span with taps 0 (the gate step's fill): a segment's span is its
    frames' extent [in_tail part | x part], (frames - 1) hop + nfft, the
    fill part the x samples after the in_tail part; with a FIR the fill
    rounds up to whole overlap-save blocks and adds the history."""
    d = nfft - hop
    span, part = ck.step_span(nfft, hop, 0, m, fs)
    segs = [(j0, min(m, j0 + fs)) for j0 in range(0, m, fs)]
    assert span == max((j1 - j0 - 1) * hop + nfft for j0, j1 in segs)
    assert part == max((j1 - j0 - 1) * hop + nfft - max(0, d - j0 * hop) for j0, j1 in segs)
    fir_span, fir_part = ck.step_span(nfft, hop, 64, m, fs)
    assert fir_part >= part + 63 and fir_span >= span

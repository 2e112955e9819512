"""The host side of the redesigned overlap_save_fused (``asp::os_regs`` in
``csrc/chain_regs_device.cuh``, ``csrc/os_kernel.cu``) and fir_mac
(``csrc/fir_kernel.cu``), on the CPU.

- A float64 numpy model of the overlap-save kernel's schedule: units (a
  channel's pair of blocks as re/im of one transform) numbered across
  channels, a CTA's batch of ``os_geometry``'s units, the loads straight
  from [hist | x] in device memory (zero past the end of x, a null history
  as zeros), every pass of ``regs_pass_plan`` on the threads' groups
  through the swizzled exchange (NaN-filled; one buffer past nfft 4096),
  the merged pass's product with the tap spectrum (``fir_middle``'s slot
  identity), and the inverse's last pass storing each block's outputs
  past its first taps - 1 points, scaled by 1/nfft, into a NaN-filled
  output whose every position is written exactly once.  It agrees with
  ``overlap_save_ref`` at >= 200 dB at nfft 2 to 16384, taps 1, 64,
  nfft/4 and nfft, n below one block, ragged and across channels inside a
  batch, with and without a history.
- A model of the MAC kernel's tiling in float32 with an exact fmaf: the
  taps zero-padded to whole chunks, the window staged through the swizzle
  into NaN-filled shared memory (the history where a tile starts the
  stream, zeros past x), each thread's 8 outputs in chunks of 16 taps and
  a guarded tail, the stores; bit for bit the taps' fmaf chains in order
  (``fmaf_reference``) at taps 1 to 898.  The window's 16-byte reads and
  writes touch 32 banks a quarter warp.
- The geometries: ``os_geometry`` launches every nfft the retired kernel
  took (2 to 16384) and raises naming SMEM_LIMIT past it, as the retired
  kernel did; ``fir_geometry`` launches every tap count the retired
  kernel took (1 to 28544) and raises naming SMEM_LIMIT past it.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels import fir_kernel as fir
from audiosignalprocess_tpu_torch.kernels import gate_kernel as gk
from audiosignalprocess_tpu_torch.kernels import os_kernel as osk
from audiosignalprocess_tpu_torch.kernels._build import SMEM_LIMIT
from audiosignalprocess_tpu_torch.ops.fir import design_fir

from test_torch_chain_regs import (
    _brev_np, _read_idx, _snr, _stages, _swizzle, _to_inverse_slots, _write_idx,
)


# ---------------------------------------------------------------------------
# the overlap-save kernel
# ---------------------------------------------------------------------------

class _Buffers:
    """The CTA's exchange buffers (cap complex points each, through the
    swizzle), NaN until written: two, or one (``one``) where every pass
    reads and writes the same buffer."""

    def __init__(self, cap, one):
        self.buf = [np.full(cap, np.nan + 0j)] * (1 if one else 2)

    def load(self, p):
        def ld(idx):
            v = self.buf[p % len(self.buf)][_swizzle(idx)]
            assert not np.isnan(v).any(), "a pass read a point no pass wrote"
            return v
        return ld

    def store(self, p):
        def st(idx, v):
            self.buf[p % len(self.buf)][_swizzle(idx)] = v
        return st


def _os_round_trip(n, nt, one, load, middle, store, twf, twi):
    """regs_round_trip on a batch of nt transforms: the forward passes, the
    merged pass (``middle``: the forward's last pass's registers (nt, 2^lg,
    RS) -> the inverse's first pass's inputs), the inverse passes; every
    pass reads all its points before it writes (the one-buffer kernel's
    hold)."""
    fwd, inv = gk.regs_pass_plan(n)
    rs = fwd[-1][1]
    lg = n.bit_length() - 1 - rs
    ex = _Buffers(nt * n, one)
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
    (store if len(inv) == 1 else ex.store(p))(_write_idx(n, nt, rs), y)
    src, p = ex.load(p), p + 1
    for k, (s0, r) in enumerate(inv[1:]):
        idx, l = _read_idx(n, nt, s0, r)
        pts = src(idx)
        _stages(pts, s0, r, twi, l)
        (store if k == len(inv) - 2 else ex.store(p))(_write_idx(n, nt, r), pts)
        src, p = ex.load(p), p + 1


def os_model(x, h, nfft, hist=None):
    """asp::os_regs in float64 on x (C, n) with the (C, taps - 1) history
    ``hist`` (None: zeros): every CTA of the launch, its batch's unit table,
    the round trip, the stores into a NaN-filled output (each position
    written once)."""
    n_ch, n = x.shape
    taps = len(h)
    hl = taps - 1
    geo = osk.os_geometry(nfft)
    nt = geo["batch"]
    blk = nfft - hl
    nblk = -(-n // blk)
    npair = -(-nblk // 2)
    units = n_ch * npair
    fwd, _ = gk.regs_pass_plan(nfft)
    rs = fwd[-1][1]
    lg = nfft.bit_length() - 1 - rs
    twf = fk.stockham_stage_table_np(nfft, -1.0)
    twi = fk.stockham_stage_table_np(nfft, 1.0)
    hf = np.fft.fft(np.concatenate([h, np.zeros(nfft - taps)]))
    bins = (_brev_np(np.arange(1 << rs), rs) << lg) + np.arange(1 << lg)[None, :, None]
    raw_rows = np.concatenate([np.zeros((n_ch, hl)) if hist is None else hist, x,
                               np.zeros((n_ch, 2 * nfft))], axis=1)
    y = np.full((n_ch, n), np.nan)
    written = np.zeros((n_ch, n), np.int64)
    for cta in range(-(-units // nt)):
        u = cta * nt + np.arange(nt)
        c = u // npair
        k = 2 * (u - c * npair)
        table = np.stack([c, k * blk, k + 1 < nblk, u < units], axis=1)  # the int4 entries

        def load(idx, table=table):
            e = table[idx // nfft]
            j = e[..., 1] + idx % nfft
            cc = np.minimum(e[..., 0], n_ch - 1)
            re = np.where(e[..., 3] == 1, raw_rows[cc, j], 0.0)
            im = np.where((e[..., 3] == 1) & (e[..., 2] == 1),
                          raw_rows[cc, np.minimum(j + blk, raw_rows.shape[1] - 1)], 0.0)
            return re + 1j * im

        def store(idx, v, table=table):
            e = table[idx // nfft]
            kk = idx % nfft - hl
            o = e[..., 1] + kk
            for part, off, ok in ((v.real, 0, e[..., 3] == 1),
                                  (v.imag, blk, (e[..., 3] == 1) & (e[..., 2] == 1))):
                sel = ok & (kk >= 0) & (o + off < n)
                y[e[..., 0][sel], (o + off)[sel]] = part[sel] / nfft
                np.add.at(written, (e[..., 0][sel], (o + off)[sel]), 1)

        def middle(xr):
            return _to_inverse_slots(xr * hf[bins], rs)

        _os_round_trip(nfft, nt, geo["one"], load, middle, store, twf, twi)
    assert (written == 1).all(), "an output position was written twice or never"
    return y


def _os_cases():
    out = []
    for nfft in (2, 16, 256, 1024, 8192, 16384):
        for taps in sorted({t for t in (1, 64, nfft // 4, nfft) if 1 <= t <= nfft}):
            blk = nfft - taps + 1
            for n in sorted({max(1, blk // 2), 2 * blk + blk // 3 + 1, 5 * blk + 3}):
                out.append((nfft, taps, n))
    return out


@pytest.mark.parametrize("nfft,taps,n", _os_cases())
@pytest.mark.parametrize("with_hist", (False, True))
def test_os_model_is_overlap_save_ref(nfft, taps, n, with_hist):
    rng = np.random.default_rng(nfft + 7 * taps + n)
    x = rng.standard_normal((3, n))
    h = rng.standard_normal(taps)
    hist = rng.standard_normal((3, taps - 1)) if with_hist else None
    got = os_model(x, h, nfft, hist)
    ref = osk.overlap_save_ref(torch.as_tensor(x), h, nfft,
                               None if hist is None else torch.as_tensor(hist)).numpy()
    assert _snr(ref, got) >= 200.0


def test_os_model_batches_cross_channels():
    """At nfft 256 a CTA's batch is four units; 3 channels of 3 pairs each
    put units of two channels in one batch, and the model still agrees."""
    geo = osk.os_geometry(256)
    assert geo["batch"] == 4
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5 * 193))  # 64 taps: blk 193, 5 blocks, 3 pairs a channel
    h = design_fir(64, 0.3)
    ref = osk.overlap_save_ref(torch.as_tensor(x), h, 256).numpy()
    assert _snr(ref, os_model(x, h, 256)) >= 200.0


@pytest.mark.parametrize("nfft", [1 << k for k in range(1, 15)])
def test_os_geometry_launches_every_old_nfft(nfft):
    """Every nfft the retired kernel took (12 nfft <= SMEM_LIMIT) launches:
    whole transforms a CTA, the exchange in shared memory under
    SMEM_LIMIT, one buffer where a transform has more than 4096 points."""
    assert 12 * nfft <= SMEM_LIMIT
    geo = osk.os_geometry(nfft)
    assert geo["smem"] <= SMEM_LIMIT
    assert geo["threads"] * geo["points"] == geo["batch"] * nfft
    assert geo["points"] == min(16, nfft) or nfft > 8192
    assert geo["one"] == (nfft > 4096)
    assert geo["threads"] == max(osk.OS_THREADS, nfft // geo["points"])
    osk.check_os_geometry(nfft, nfft)  # taps up to nfft: one output a block


@pytest.mark.parametrize("nfft", (32768, 65536, 1 << 20))
def test_os_geometry_raises_where_the_old_kernel_did(nfft):
    assert 12 * nfft > SMEM_LIMIT
    with pytest.raises(ValueError, match="SMEM_LIMIT"):
        osk.os_geometry(nfft)


def test_os_geometry_at_the_stream_block():
    """Phase 9b's launch (64 x 4096, nfft 1024, 64 taps): 3 units a channel,
    192 CTAs of OS_THREADS threads, one transform each."""
    geo = osk.os_geometry(1024)
    blk = 1024 - 63
    units = 64 * -(-(-(-4096 // blk)) // 2)
    assert units == 192 and geo["batch"] == 1 and geo["threads"] == osk.OS_THREADS


# ---------------------------------------------------------------------------
# the MAC kernel
# ---------------------------------------------------------------------------

def fmaf32(a, b, c):
    """fmaf on float32 arrays, exactly: the product is exact in float64,
    the sum's error exact by TwoSum, and the sum rounded to odd in float64
    (53 >= 24 + 2 bits) rounds once more to float32 correctly."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(np.int64)
    fix = (e != 0) & ((bits & 1) == 0)
    bits = np.where(fix, bits + np.where((e > 0) == (s > 0), 1, -1), bits)
    return bits.view(np.float64).astype(np.float32)


def fmaf_reference(x, h, hist=None):
    """The taps' fmaf chains in order on float32 x (C, n): y[o] = fmaf over
    j = 0 .. T-1 of hr[j] raw[o + j], hr the float32 reversed taps, raw
    [hist | x] in float32, from 0."""
    x = np.asarray(x, np.float32)
    hr = np.asarray(h, np.float64)[::-1].astype(np.float32)
    taps = len(hr)
    n_ch, n = x.shape
    pre = np.zeros((n_ch, taps - 1), np.float32) if hist is None else np.asarray(hist, np.float32)
    raw = np.concatenate([pre, x], axis=1)
    acc = np.zeros((n_ch, n), np.float32)
    for j in range(taps):
        acc = fmaf32(hr[j], raw[:, j:j + n], acc)
    return acc


def _win_swz(w):
    """csrc/fir_kernel.cu win_swz: bits 5 and up of the index into bits 2
    and up, OUTPUTS / 4 of them."""
    return w ^ (((w >> 5) & (fir.OUTPUTS // 4 - 1)) << 2)


def mac_model(x, h, hist=None):
    """fir_mac_kernel on float32 x (C, n): every CTA (tile, channel) stages
    the zero-padded reversed taps and its window through the swizzle into
    NaN-filled shared memory, and each thread runs its OUTPUTS outputs over
    the chunks of CHUNK taps and the guarded tail with exact fmaf."""
    x = np.asarray(x, np.float32)
    n_ch, n = x.shape
    taps = len(h)
    hl = taps - 1
    geo = fir.fir_geometry(taps)
    threads = geo["threads"]
    P, C = fir.OUTPUTS, fir.CHUNK
    tile = threads * P
    assert geo["tile"] == tile and geo["smem"] == 4 * (2 * -(-taps // C) * C + tile)
    tp = -(-taps // C) * C
    wl = tile + tp
    hr = np.zeros(tp, np.float32)
    hr[:taps] = np.asarray(h, np.float64)[::-1].astype(np.float32)
    y = np.full((n_ch, n), np.nan, np.float32)
    written = np.zeros((n_ch, n), np.int64)
    pre = np.zeros((n_ch, hl), np.float32) if hist is None else np.asarray(hist, np.float32)
    o0 = np.arange(threads)[:, None] * P + np.arange(P)  # (threads, P)
    for c in range(n_ch):
        for t0 in range(0, n, tile):
            win = np.full(wl, np.nan, np.float32)
            i = np.arange(wl)
            g = t0 - hl + i
            vals = np.where(g < 0, pre[c, np.clip(t0 + i, 0, max(hl - 1, 0))] if hl else 0.0,
                            np.where(g < n, x[c, np.clip(g, 0, n - 1)], 0.0))
            win[_win_swz(i)] = vals  # 4-float groups, each to its swizzled place
            acc = np.zeros((threads, P), np.float32)
            for c0 in range(0, tp, C):
                rem = min(C, taps - c0)
                idx = o0[:, :1] + c0 + np.arange(P + C)  # the chunk's window reads
                w = win[_win_swz(idx)]
                for j in range(rem):
                    acc = fmaf32(hr[c0 + j], w[:, j:j + P], acc)
            count = min(tile, n - t0)
            out = acc.reshape(-1)[:count]
            y[c, t0:t0 + count] = out
            written[c, t0:t0 + count] += 1
    assert (written == 1).all()
    return y


MAC_TAPS = (1, 2, 7, 8, 9, 128, 129, 256, 257, 897, 898)


@pytest.mark.parametrize("taps", MAC_TAPS)
@pytest.mark.parametrize("with_hist", (False, True))
@pytest.mark.parametrize("tiles", (0.4, 2.3))
def test_mac_model_is_the_fmaf_chain(taps, with_hist, tiles):
    """The kernel's tiling (FIR_THREADS threads of OUTPUTS outputs a tile)
    against the fmaf chains in order: bit for bit, on a length below one
    tile (shorter than the longest histories) and a ragged one of several."""
    rng = np.random.default_rng(taps + int(10 * tiles))
    n = int(tiles * fir.FIR_THREADS * fir.OUTPUTS) + 13
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = design_fir(taps, 0.05) if taps >= 8 else rng.standard_normal(taps)
    hist = rng.standard_normal((2, taps - 1)).astype(np.float32) if with_hist else None
    got = mac_model(x, h, hist)
    ref = fmaf_reference(x, h, hist)
    assert np.array_equal(got, ref)
    plain = fir.fir_mac_ref(torch.as_tensor(x, dtype=torch.float64), h,
                            None if hist is None else torch.as_tensor(hist, dtype=torch.float64))
    assert _snr(plain.numpy(), got) >= 120.0


def _round_f32(q):
    """The float32 nearest the rational q, ties to even."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    key = lambda v: (abs(Fraction(float(v)) - q), int(np.array(v).view(np.int32)) & 1)
    return min(cands, key=key)


def test_fmaf32_is_one_rounding():
    """fmaf32 against exact rationals: a case where rounding the sum to
    float64 first lands on a float32 tie (a b + c = 1 + 2^-24 + 2^-54, which
    float64 rounds to the tie 1 + 2^-24 and then to even, 1.0), and random
    operands of mixed scales."""
    a = np.float32(2.0 ** -12 * (1 - 2.0 ** -15))
    b = np.float32(-(2.0 ** -12) * (1 + 2.0 ** -15))
    c = np.float32(1 + 2.0 ** -23)
    assert np.float32(np.float64(a) * np.float64(b) + np.float64(c)) == np.float32(1.0)
    assert fmaf32(a, b, c) == np.float32(1 + 2.0 ** -23)
    rng = np.random.default_rng(5)
    u, v, w = (rng.standard_normal(2000).astype(np.float32) * np.float32(2.0) **
               rng.integers(-30, 30, 2000).astype(np.float32) for _ in range(3))
    got = fmaf32(u, v, w)
    for k in range(2000):
        q = Fraction(float(u[k])) * Fraction(float(v[k])) + Fraction(float(w[k]))
        assert got[k] == _round_f32(q)


def _quarter_banks(addrs):
    """The 32 banks a quarter warp's 16-byte reads touch: addrs (8,) float
    offsets, each a 4-float group."""
    return {(a + k) % 32 for a in addrs for k in range(4)}


def test_mac_window_reads_touch_32_banks():
    """Every chunk's 16-byte window reads (offset c0 + 4m, any multiple of
    4) of 8 neighbouring threads at a stride of OUTPUTS floats: 32 distinct
    banks through win_swz, where the plain layout touches 32 / (OUTPUTS /
    4) banks OUTPUTS / 4 times; and the staging's 16-byte writes (8
    neighbouring groups) also 32."""
    P = fir.OUTPUTS
    for q0 in range(0, fir.FIR_THREADS, 8):
        for a in range(0, 16 * P, 4):
            addrs = [_win_swz(P * q + a) for q in range(q0, q0 + 8)]
            assert len(_quarter_banks(addrs)) == 32
            plain = [P * q + a for q in range(q0, q0 + 8)]
            assert len(_quarter_banks(plain)) == 32 // (P // 4)
    for g0 in range(0, 4096, 32):
        assert len(_quarter_banks([_win_swz(g0 + 4 * k) for k in range(8)])) == 32


def test_fir_geometry_launches_every_old_tap_count():
    """Every tap count the retired kernel took (4 (2T + 1023) <= SMEM_LIMIT,
    1 to 28544) launches, at FIR_THREADS threads (the retired tile of 1024
    outputs); it raises naming SMEM_LIMIT exactly where the retired kernel
    raised."""
    old_max = max(t for t in range(1, 30000) if 4 * (2 * t + 1023) <= SMEM_LIMIT)
    assert old_max == 28544
    for taps in range(1, old_max + 1):
        geo = fir.fir_geometry(taps)
        assert geo["smem"] <= SMEM_LIMIT and geo["tile"] == 1024
    for taps in (old_max + 1, 30000, 100000):
        with pytest.raises(ValueError, match="SMEM_LIMIT"):
            fir.fir_geometry(taps)


def test_fir_geometry_at_the_stream_block():
    """Phase 9b's launch (64 x 4096, the 129-tap envelope): tiles of 1024
    outputs, 4 a channel, 256 CTAs of 128 threads on 132 SMs."""
    geo = fir.fir_geometry(129)
    assert geo == dict(threads=128, smem=4 * (2 * 144 + 1024), tile=1024)
    assert 64 * -(-4096 // geo["tile"]) == 256

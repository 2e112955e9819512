"""The host side of rfft_stockham and irfft_stockham, redesigned for Hopper
on the register Stockham passes, on the CPU.

- Both kernels run the m = n/2-point complex transform of a real row in
  fft_stockham_lanes' passes (``stockham_group``/``stockham_groups`` in
  ``csrc/fft_regs.cuh``), on the plan of ``real_stockham_passes``.  rfft
  reads the pack z[k] = x[2k] + i x[2k+1] as its first pass's loads and
  untangles in its last pass, whose groups go in pairs so that a thread
  holds Z[k] and Z[(m - k) mod m]; irfft untangles the bins as its first
  pass loads them, in the same pairs (each bin read once), and writes z[k]
  / m interleaved as its last pass's stores.  A float32 numpy model of
  each kernel (the CTAs of ``real_stockham_geometry``, NaN-filled exchange
  buffers, the swizzle, the pairs and their partner slots, the untangle in
  the plain version's operation order) is held bit-equal to
  ``rfft_stockham_ref`` / ``irfft_stockham_ref`` at every n from 4 to
  32768, on a CTA's rows and one more, and >= 100 dB against the JAX
  package's ``rfft_stockham`` / ``irfft_stockham`` (interpret mode).
- The m-point per-stage table is held bit-equal to the twiddles the plain
  version reads, and to the n/2-point untangle table at stride 2.
- Every warp access of the exchange is counted on its banks: conflict-free
  in the passes that run every group, at most 2 ways in the paired pass.
- The pass plans cover every stage once, and ``real_stockham_geometry``
  fits the card's shared memory to n = 2^24, with the exchange in a
  scratch buffer past m = 8192.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.kernels import fft_kernel as jax_fk
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels._build import SMEM_LIMIT

SIZES = [1 << k for k in range(2, 16)]  # n = 4 to 32768: m = 2 to 16384


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref ** 2) / err)


def _brev(v, bits):
    """v < 2^bits bit-reversed."""
    out = 0
    for k in range(bits):
        out |= ((v >> k) & 1) << (bits - 1 - k)
    return out


def _swizzle(i):
    """csrc/fft_regs.cuh pease_swizzle: bits 5..8 XORed into bits 0..3 and
    their parity into bit 4, bits 9..11 into bits 0..2."""
    x = (i >> 5) & 15
    parity = (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3)) & 1
    return i ^ x ^ (parity << 4) ^ ((i >> 9) & 7)


def _cplx(re, im):
    """complex64 from float32 parts, with no arithmetic on either."""
    out = np.empty(np.shape(re), np.complex64)
    out.real, out.imag = re, im
    return out


def _table(m, sign):
    return fk.stockham_stage_table_np(m, sign).astype(np.complex64)


def _untangle_tw(n):
    return fk._twiddles_np(n).astype(np.complex64)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _stages(pts, s0, r, l, tab):
    """stockham_pass: the r stages from s0 on the slots ``pts`` of groups
    with segment bits ``l``: stage s0 + b pairs slot j with j + 2^(r-1-b)
    under the table's entry 2^(s0+b) - 1 + brev_b(j >> (r - b)) 2^s0 + l."""
    big_r = 1 << r
    pts = list(pts)
    for b in range(r):
        h = 1 << (r - 1 - b)
        for j in range(big_r):
            if j & h:
                continue
            w = tab[(1 << (s0 + b)) - 1 + (_brev(j >> (r - b), b) << s0) + l]
            u, x = pts[j], pts[j + h]
            tr = x.real * w.real - x.imag * w.imag
            ti = x.real * w.imag + x.imag * w.real
            pts[j] = _cplx(u.real + tr, u.imag + ti)
            pts[j + h] = _cplx(u.real - tr, u.imag - ti)
    return pts


def _group(load, v, s0, r, m, tab):
    """stockham_group for the groups v (an array): group v is row v >> lg,
    q = v mod 2^lg (lg = log2 m - r), q = l 2^pw + p; slot j is load(row m
    + l 2^(L - s0) + j 2^pw + p); then the pass's stages.  Returns the
    slots and the write base row m + q (slot j belongs at base + brev_r(j)
    2^lg).  Indices are CTA-local and natural: ``load`` applies the swizzle
    where its side is the exchange."""
    big_l = m.bit_length() - 1
    lg = big_l - r
    pw = lg - s0
    row, q = v >> lg, v & ((1 << lg) - 1)
    l, p = q >> pw, q & ((1 << pw) - 1)
    i0 = row * m + (l << (big_l - s0)) + p
    return _stages([load(i0 + (j << pw)) for j in range(1 << r)], s0, r, l, tab), row * m + q


def _put(store, pts, base, r, m):
    """stockham_put: slot j to store(base + brev_r(j) 2^lg)."""
    lg = m.bit_length() - 1 - r
    for j, x in enumerate(pts):
        store(base + (_brev(j, r) << lg), x)


def _pass(load, store, s0, r, m, rows, tab):
    """stockham_groups: every group of ``rows`` rows read, staged, put."""
    v = np.arange(rows << (m.bit_length() - 1 - r))
    pts, base = _group(load, v, s0, r, m, tab)
    _put(store, pts, base, r, m)


class _Exchange:
    """A CTA's exchange buffer of ``size`` complex points, NaN until
    written, addressed through the swizzle."""

    def __init__(self, size):
        self.z = np.full(size, np.nan, np.complex64)

    def load(self, i):
        return self.z[_swizzle(i)]

    def store(self, i, v):
        self.z[_swizzle(i)] = v


def _ctas(b, rows):
    """(first row, rows) of each CTA of a b-row launch."""
    return [(c, min(rows, b - c)) for c in range(0, b, rows)]


def _units(rows, m, r):
    """The paired pass's units: (row, q, partner q2, own) of unit u < rows
    2^(lg-1) (lg = log2 m - r): groups q = u mod 2^(lg-1) and 2^lg - q,
    unit 0 of a row groups 0 and 2^(lg-1), each its own partner; with one
    group a row (lg = 0) the group alone."""
    lg = m.bit_length() - 1 - r
    lu = max(lg - 1, 0)
    u = np.arange(rows << lu)
    row, q = u >> lu, u & ((1 << lu) - 1)
    own = q == 0
    q2 = np.zeros_like(q) if lg == 0 else np.where(own, 1 << (lg - 1), (1 << lg) - q)
    return row, q, q2, own


def _own_mirror(j, r):
    """Group 0's slot holding Z[(m - k) mod m] for its slot j: brev_r(-brev_r(j) mod 2^r)."""
    return _brev((-_brev(j, r)) % (1 << r), r)


def _untangle_bin(z, zc, wk):
    """X[k] from Z[k] and Z[(m - k) mod m] (the kernel's untangle_bin)."""
    cr, ci = zc.real, -zc.imag
    er, ei = 0.5 * (z.real + cr), 0.5 * (z.imag + ci)
    or_, oi = 0.5 * (z.imag - ci), -0.5 * (z.real - cr)
    return er + wk.real * or_ - wk.imag * oi, ei + wk.real * oi + wk.imag * or_


def rfft_model(x):
    """rfft_stockham's kernel in float32 numpy: per CTA of
    ``real_stockham_geometry(n)``, the passes of ``real_stockham_passes(n)``:
    the first loads z[k] = x[2k] + i x[2k+1] as one complex64 (the float2
    of the row), each but the last writes exchange buffer p mod 2 through
    the swizzle, and the last runs its groups in the kernel's pairs and
    untangles from their slots: X[k] of slot j from its partner slot (RS - 1
    - j of the other group, or group 0's own mirror slot), X[m] = Re Z[0] -
    Im Z[0], in the plain version's operation order."""
    b, n = x.shape
    m = n // 2
    rows = fk.real_stockham_geometry(n)[0]
    tab, w = _table(m, -1.0), _untangle_tw(n)
    z_in = np.ascontiguousarray(x, np.float32).view(np.complex64)  # (b, m)
    sr = np.full((b, m + 1), np.nan, np.float32)
    si = np.full((b, m + 1), np.nan, np.float32)
    passes = fk.real_stockham_passes(n)
    for row0, valid in _ctas(b, rows):
        rows_in = z_in[row0:row0 + valid].reshape(-1)
        ex = [_Exchange(rows * m), _Exchange(rows * m)]
        for k, (s0, r) in enumerate(passes[:-1]):
            load = (lambda i: rows_in[i]) if k == 0 else ex[(k + 1) % 2].load
            _pass(load, ex[k % 2].store, s0, r, m, valid, tab)
        s0, r = passes[-1]
        load = (lambda i: rows_in[i]) if len(passes) == 1 else ex[len(passes) % 2].load
        lg = m.bit_length() - 1 - r
        row, q, q2, own = _units(valid, m, r)
        zs, _ = _group(load, (row << lg) | q, s0, r, m, tab)
        ys, _ = _group(load, (row << lg) | q2, s0, r, m, tab)
        out = row0 + row
        for j in range(1 << r):
            k = _brev(j, r) << lg
            zc = np.where(own, zs[_own_mirror(j, r)], ys[(1 << r) - 1 - j]) if lg else \
                zs[_own_mirror(j, r)]
            sr[out, k + q], si[out, k + q] = _untangle_bin(zs[j], zc, w[k + q])
            if lg:
                yc = np.where(own, ys[(1 << r) - 1 - j], zs[(1 << r) - 1 - j])
                sr[out, k + q2], si[out, k + q2] = _untangle_bin(ys[j], yc, w[k + q2])
        sr[out[own], m] = zs[0].real[own] - zs[0].imag[own]
        si[out[own], m] = 0.0
    return sr, si


def _retangle_bin(s, sc, wk):
    """z[k] from S[k] and S[m - k] (the kernel's retangle_bin)."""
    cr, ci = sc.real, -sc.imag
    er, ei = 0.5 * (s.real + cr), 0.5 * (s.imag + ci)
    dr, di = 0.5 * (s.real - cr), 0.5 * (s.imag - ci)
    wc, ws = wk.real, -wk.imag
    or_, oi = dr * wc - di * ws, dr * ws + di * wc
    return _cplx(er - oi, ei + or_)


def irfft_model(sr, si, n):
    """irfft_stockham's kernel in float32 numpy: per CTA of
    ``real_stockham_geometry(n)``, the passes of ``real_stockham_passes(n,
    inverse=True)``: the first runs its groups in the kernel's pairs,
    reading each bin once (S[k] of slot j, and S[m - k] from the partner
    slot, or S[m] for bin 0; Im S[0] and Im S[m] dropped) and forming z[k] =
    E[k] + i O[k] with conj(w^k); the exchange between passes goes through
    the swizzle, and the last pass stores z[k] / m as y[2k], y[2k+1] (a
    complex64 of the row) in natural order."""
    b = sr.shape[0]
    m = n // 2
    big_l = m.bit_length() - 1
    rows = fk.real_stockham_geometry(n)[0]
    tab, w = _table(m, 1.0), _untangle_tw(n)
    inv = np.float32(1.0 / m)
    y = np.full((b, n), np.nan, np.float32)
    y_c = y.view(np.complex64)  # (b, m): y[2k] + i y[2k+1]
    passes = fk.real_stockham_passes(n, inverse=True)
    for row0, valid in _ctas(b, rows):
        def scaled(i, v):
            y_c[row0 + (i >> big_l), i & (m - 1)] = _cplx(v.real * inv, v.imag * inv)

        ex = [_Exchange(rows * m), _Exchange(rows * m)]
        _, r = passes[0]
        pw = big_l - r
        row, q, q2, own = _units(valid, m, r)
        s_r, s_i = sr[row0 + row], si[row0 + row]  # each unit's row
        at = np.arange(len(row))

        def bins(g, j):
            return _cplx(s_r[at, (j << pw) | g], s_i[at, (j << pw) | g])

        big_r = 1 << r
        ss = [bins(q, j) for j in range(big_r)]
        ts = [bins(q2, j) for j in range(big_r)]
        ss[0] = _cplx(ss[0].real, np.where(own, np.float32(0.0), ss[0].imag))  # Im S[0]
        sm = _cplx(s_r[at, m], np.zeros(len(row), np.float32))  # S[m], Im dropped
        zs, ys = [], []
        for j in range(big_r):
            if j == 0:
                sc = np.where(own, sm, ts[big_r - 1])
            else:
                sc = np.where(own, ss[big_r - j], ts[big_r - 1 - j])
            tc = np.where(own, ts[big_r - 1 - j], ss[big_r - 1 - j])
            zs.append(_retangle_bin(ss[j], sc, w[(j << pw) | q]))
            ys.append(_retangle_bin(ts[j], tc, w[(j << pw) | q2]))
        store = scaled if len(passes) == 1 else ex[0].store
        _put(store, _stages(zs, 0, r, 0, tab), row * m + q, r, m)
        if pw:
            _put(store, _stages(ys, 0, r, 0, tab), row * m + q2, r, m)
        for k, (s0, r) in enumerate(passes[1:], start=1):
            last = k == len(passes) - 1
            _pass(ex[(k + 1) % 2].load, scaled if last else ex[k % 2].store, s0, r, m, valid,
                  tab)
    return y


def _rows(n):
    """A CTA's rows and one more (a partial last CTA); 3 rows where a CTA
    takes one."""
    rows = fk.real_stockham_geometry(n)[0]
    return rows + 1 if rows > 1 else 3


@pytest.mark.parametrize("n", SIZES)
def test_rfft_model_is_the_plain_version(n):
    """The model runs every operation of rfft_stockham_ref with its
    operands: float32 bins bit-equal to it (both planes, bin m included),
    no NaN of an unwritten exchange point reaching them; >= 100 dB against
    the JAX package's rfft_stockham on the same rows."""
    x = np.random.default_rng(130 + n).standard_normal((_rows(n), n)).astype(np.float32)
    mr, mi = rfft_model(x)
    pr, pi = fk.rfft_stockham_ref(torch.as_tensor(x))
    assert np.array_equal(mr.view(np.uint32), pr.numpy().view(np.uint32))
    assert np.array_equal(mi.view(np.uint32), pi.numpy().view(np.uint32))
    jr, ji = jax_fk.rfft_stockham(jnp.asarray(x))
    assert _snr(np.concatenate([np.asarray(jr), np.asarray(ji)]),
                np.concatenate([mr, mi])) >= 100.0


@pytest.mark.parametrize("n", SIZES)
def test_irfft_model_is_the_plain_version(n):
    """The model runs every operation of irfft_stockham_ref: float32 rows
    bit-equal to it, on random bins whose imaginary parts on bins 0 and m
    both drop and on a real row's spectrum; >= 100 dB against the JAX
    package's irfft_stockham on the spectrum (the JAX kernel keeps those
    imaginary parts: the accepted difference of the port's irfft)."""
    rng = np.random.default_rng(131 + n)
    b, m = _rows(n), n // 2
    x = rng.standard_normal((b, n))
    spec = np.fft.rfft(x)
    for sr, si in ((rng.standard_normal((b, m + 1)), rng.standard_normal((b, m + 1))),
                   (spec.real, spec.imag)):
        sr, si = sr.astype(np.float32), si.astype(np.float32)
        y = irfft_model(sr, si, n)
        ref = fk.irfft_stockham_ref(torch.as_tensor(sr), torch.as_tensor(si), n).numpy()
        assert np.array_equal(y.view(np.uint32), ref.view(np.uint32))
    jy = jax_fk.irfft_stockham(jnp.asarray(sr), jnp.asarray(si), n)
    assert _snr(np.asarray(jy), y) >= 100.0


def test_models_round_trip():
    """irfft of rfft gives the rows back (float32 rounding only)."""
    for n in (4, 64, 1024, 32768):
        x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
        assert _snr(x, irfft_model(*rfft_model(x), n)) >= 130.0


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sign", (-1.0, 1.0))
def test_half_size_table_is_bit_equal(n, sign):
    """Stage s's segment l of the m-point per-stage table that the kernels
    receive is, in float32 bit for bit, the twiddle the plain version's
    m-point stages read (tw_m[l << (log2 m - 1 - s)]) and the n/2-point
    untangle table at stride 2 (tw_n[2 (l << (log2 m - 1 - s))]), which the
    radix-2 loop read; conjugated for the inverse."""
    m = n // 2
    got = fk.stockham_table(m, -1 if sign < 0 else 1, torch.device("cpu")).numpy()
    got = got.view(np.complex64)
    tw_m, tw_n = (fk._twiddles_np(k).astype(np.complex64) for k in (m, n))
    if sign > 0:
        tw_m, tw_n = tw_m.conj(), tw_n.conj()
    big_l = m.bit_length() - 1
    assert got.shape == (m - 1,)
    for s in range(big_l):
        l = np.arange(1 << s)
        have = got[(1 << s) - 1 + l].view(np.uint64)
        assert np.array_equal(have, tw_m[l << (big_l - 1 - s)].view(np.uint64))
        assert np.array_equal(have, tw_n[2 * (l << (big_l - 1 - s))].view(np.uint64))


# ---------------------------------------------------------------------------
# the exchange's banks
# ---------------------------------------------------------------------------

def _slot_accesses(m, s0, r, row, q):
    """(reads, writes) of slot j of the groups (row, q) of a pass from s0
    (each an array of warps x 32 lanes, -1 where a lane is idle): the read
    at row m + l 2^(L - s0) + j 2^pw + p, the write at row m + brev_r(j)
    2^lg + q."""
    big_l = m.bit_length() - 1
    lg = big_l - r
    pw = lg - s0
    l, p = q >> pw, q & ((1 << pw) - 1)
    idle = row < 0
    reads = [np.where(idle, -1, row * m + (l << (big_l - s0)) + (j << pw) + p)
             for j in range(1 << r)]
    writes = [np.where(idle, -1, row * m + (_brev(j, r) << lg) + q) for j in range(1 << r)]
    return reads, writes


def _warps(*a):
    """Arrays of lanes cut into warps of 32 (the tail padded with -1)."""
    pad = -len(a[0]) % 32
    return [np.concatenate([x, np.full(pad, -1)]).reshape(-1, 32) for x in a]


def exchange_accesses(n, inverse):
    """Every warp access of the exchange at n, swizzled as the kernel
    addresses it, by kind: ``pass``, the passes that run every group
    (stockham_groups: 32 consecutive groups a warp; their reads after the
    first pass and their writes before the last), and ``paired``, the
    untangle's pass, which runs groups in pairs (32 consecutive units a
    warp, each reading or writing slot j of both its groups): rfft's last
    pass reads the exchange, irfft's first pass writes it (where there is a
    later pass).  Idle lanes are -1."""
    m = n // 2
    big_l = m.bit_length() - 1
    rows = fk.real_stockham_geometry(n)[0]
    passes = fk.real_stockham_passes(n, inverse)
    paired = 0 if inverse else len(passes) - 1
    acc = {"pass": [], "paired": []}
    for k, (s0, r) in enumerate(passes):
        lg = big_l - r
        if k == paired:
            row, q, q2, _ = _units(rows, m, r)
            row, q, q2 = _warps(row, q, q2)
            ra, wa = _slot_accesses(m, s0, r, row, q)
            rb, wb = _slot_accesses(m, s0, r, row, q2)
            if not inverse and len(passes) > 1:
                acc["paired"] += ra + rb
            if inverse and len(passes) > 1:
                acc["paired"] += wa + wb
            continue
        v, = _warps(np.arange(rows << lg))
        row, q = np.where(v < 0, -1, v >> lg), v & ((1 << lg) - 1)
        reads, writes = _slot_accesses(m, s0, r, row, q)
        if k > 0:
            acc["pass"] += reads
        if k < len(passes) - 1:
            acc["pass"] += writes
    return {key: (np.concatenate([_swz(a) for a in v]) if v else np.zeros((0, 32), int))
            for key, v in acc.items()}


def _swz(a):
    return np.where(a < 0, -1, _swizzle(np.maximum(a, 0)))


def _ways(idx):
    """The worst bank conflict of a set of warp accesses: the most distinct
    addresses of one access on one bank (4-byte planes: bank = index mod
    32; lanes on one address are a broadcast)."""
    worst = 0
    for row in idx:
        a = np.unique(row[row >= 0])
        worst = max(worst, int(np.bincount(a & 31, minlength=32).max()) if len(a) else 0)
    return worst


# the worst ways of the untangle's paired pass, by (inverse, n)
PAIRED_WAYS = {**{(inv, n): 2 for inv in (False, True) for n in SIZES if n >= 64},
               (False, 64): 1, (True, 256): 1}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("inverse", (False, True))
def test_exchange_banks(n, inverse):
    """Every access of a pass that runs every group touches 32 distinct
    banks.  The untangle's pass runs its groups in pairs, u and 2^lg - u:
    from n = 512 on, slot j of the first groups of 32 consecutive units is
    conflict-free, while their partners, 32 groups counted down, straddle
    two blocks of 32 points whose swizzles differ and meet 2 ways (below
    512 a warp spans rows); the ways of that pass are recorded in
    PAIRED_WAYS.  No access reads the exchange for the untangle's mirror:
    it is in the registers of the unit."""
    acc = exchange_accesses(n, inverse)
    if len(acc["pass"]):
        assert _ways(acc["pass"]) == 1
    passes = fk.real_stockham_passes(n, inverse)
    assert (len(acc["paired"]) > 0) == (len(passes) > 1) == (n >= 64)
    if len(acc["paired"]):
        assert _ways(acc["paired"]) == PAIRED_WAYS[inverse, n]
        first = acc["paired"][: len(acc["paired"]) // 2]  # slot j of the first groups
        assert (_ways(first) == 1) == (n >= 512 or (inverse, n) in ((False, 64), (True, 256)))


# ---------------------------------------------------------------------------
# geometry and wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << k for k in range(2, 25)])
@pytest.mark.parametrize("inverse", (False, True))
def test_real_passes_cover_every_stage_once(n, inverse):
    """Every stage of the m = n/2-point transform once, in order, at most
    four a pass; past m = 16 the untangle's pass (last in rfft, first in
    irfft) takes log2 m mod 4 stages, or 1 beside a pass of three where
    log2 m is a multiple of 4, so its pairs of groups hold at most 16
    points a thread.  n = 1024: 4 + 4 + 1 stages (rfft), 1 + 4 + 4 (irfft),
    2 barriers each where the radix-2 loop took 11."""
    m = n // 2
    big_l = m.bit_length() - 1
    passes = fk.real_stockham_passes(n, inverse)
    assert [s for s0, r in passes for s in range(s0, s0 + r)] == list(range(big_l))
    assert all(1 <= r <= 4 for _, r in passes)
    if big_l <= 4:
        assert passes == [(0, big_l)]
    else:
        paired = passes[0] if inverse else passes[-1]
        assert paired[1] == (big_l % 4 or 1)
        assert sorted(r for _, r in passes if (_, r) != paired) == \
            ([3] if big_l % 4 == 0 else []) + [4] * ((big_l - (big_l % 4 or 1)) // 4)
        assert len(passes) == -(-big_l // 4) + (big_l % 4 == 0)
    if n == 1024:
        assert passes == ([(0, 1), (1, 4), (5, 4)] if inverse else [(0, 4), (4, 4), (8, 1)])


@pytest.mark.parametrize("n", [1 << k for k in range(2, 25)])
def test_real_stockham_geometry_fits(n):
    """To n = 2^24: RADIX2_POINTS points of the m = n/2-point transform a
    CTA (16 a thread of 256); the exchange buffers of its rows (two of 2 m
    floats a row; one for two passes, none for one: both kernels read their
    first pass from device memory and write their last there) in shared
    memory within SMEM_LIMIT up to m = 8192, past it both in scratch;
    every CTA-local index fits a 32-bit int."""
    m = n // 2
    rows, smem, scratch = fk.real_stockham_geometry(n)
    assert rows * m == max(m, fk.RADIX2_POINTS) and smem <= SMEM_LIMIT
    passes = len(fk.real_stockham_passes(n))
    assert passes == len(fk.real_stockham_passes(n, inverse=True))
    if scratch == 0:
        assert smem == min(2, passes - 1) * 8 * rows * m
    assert (scratch > 0) == (m > 8192) and scratch in (0, 4 * rows * m)
    assert 4 * rows * m < 2 ** 31
    if n == 1024:
        assert (rows, smem) == (8, 2 * 8 * 4096)


def test_wrappers_hand_their_own_table_and_geometry(monkeypatch):
    """Off the CPU the wrappers launch with the m-point per-stage table of
    their sign and their own geometry; there is no other launch path."""
    seen = []
    monkeypatch.setattr(fk, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(fk, "_aligned", lambda x: x)
    monkeypatch.setattr(fk, "stockham_table", lambda m, s, dev: ("table", m, s))
    monkeypatch.setattr(fk, "_launch", lambda name, what, *a: seen.append((name, *a[-4:])))
    fk.rfft_stockham(torch.empty((3, 1024), device="meta"))
    sr = torch.empty((3, 513), device="meta")
    fk.irfft_stockham(sr, sr, 1024)
    assert seen == [
        ("asp_rfft_stockham", -1, torch.device("meta"), ("table", 512, -1),
         fk.real_stockham_geometry(1024)),
        ("asp_irfft_stockham", 1, torch.device("meta"), ("table", 512, 1),
         fk.real_stockham_geometry(1024)),
    ]
    assert not hasattr(fk, "launch_geometry")

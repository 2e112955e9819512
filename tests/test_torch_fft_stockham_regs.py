"""The host side of fft_stockham_lanes and fft_stockham_manual, redesigned
for Hopper as register-resident Stockham passes, on the CPU.

- Both kernels run the self-sorting Stockham radix-2 stages four at a time
  in registers (``stockham_pass`` in ``csrc/fft_regs.cuh``): a thread holds
  the 16 points of its group, runs four stages on them and writes them
  back.  A numpy model of those passes (the points each thread reads, the
  segments' twiddles from the per-stage table, the swizzled exchange, the
  natural-order output), in the grid kernel's CTAs and in the copy ring's
  slot and work tile, is held bit-equal to ``fft_stockham_lanes_ref`` at
  every n from 2 to 16384 (8192 for the ring), both signs, and >= 100 dB
  against the JAX package's ``fft_stockham_lanes`` (interpret mode).
- The per-stage table (``stockham_stage_table_np``) is held bit-equal in
  float32 to the twiddles the plain version reads.
- Under the exchange's swizzle (``pease_swizzle``, reused) every warp
  access of every pass touches 32 banks, at every n from 2 to 8192 in
  both kernels' geometries.
- The ring's result lands in the work tile for an odd number of passes and
  in the slot for an even one: the model's ping-pong agrees with the
  kernel's ``in_work``, which its hazard guards read.
- Both launch geometries fit the card's shared memory up to 2^24 (the
  grid kernel) or raise past 8192 (the ring).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.kernels import fft_kernel as jax_fk
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels._build import SMEM_LIMIT

SIZES = [1 << k for k in range(1, 15)]  # 2 to 16384
RING_SIZES = SIZES[:-1]  # 2 to 8192
SIGNS = (-1.0, 1.0)


def _snr(ref, got):
    ref, got = np.asarray(ref, np.complex128), np.asarray(got, np.complex128)
    err = np.sum(np.abs(ref - got) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2) / err)


def _brev(v, bits):
    """v < 2^bits bit-reversed (elementwise)."""
    v = np.asarray(v)
    out = np.zeros_like(v)
    for k in range(bits):
        out |= ((v >> k) & 1) << (bits - 1 - k)
    return out


def _swizzle(i):
    """csrc/fft_regs.cuh pease_swizzle: bits 5..8 XORed into bits 0..3 and
    their parity into bit 4, bits 9..11 into bits 0..2."""
    x = (i >> 5) & 15
    parity = (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3)) & 1
    return i ^ x ^ (parity << 4) ^ ((i >> 9) & 7)


def _plain(i):
    return i


# ---------------------------------------------------------------------------
# the per-stage table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sign", SIGNS)
def test_stockham_stage_table_is_bit_equal(n, sign):
    """Stage s's segment l, at offset 2^s - 1 of the table the kernels
    receive, is the plain version's twiddle tw[l << (log2 n - 1 - s)] of
    the n/2-point table (conjugated for the inverse) in float32, bit for
    bit, for every l < 2^s: n - 1 entries."""
    assert fk.stockham_stage_table_np(n, sign).shape == (n - 1,)
    got = fk.stockham_table(n, -1 if sign < 0 else 1, torch.device("cpu"))
    got = got.numpy().view(np.complex64)
    tw = fk._twiddles_np(n).astype(np.complex64)
    if sign > 0:
        tw = tw.conj()
    big_l = n.bit_length() - 1
    for s in range(big_l):
        l = np.arange(1 << s)
        have = got[(1 << s) - 1 + l]
        assert np.array_equal(have.view(np.uint64), tw[l << (big_l - 1 - s)].view(np.uint64))


# ---------------------------------------------------------------------------
# a model of the kernels' passes
# ---------------------------------------------------------------------------

def _pass(src, read_at, s0, r, n, rows, tab, write_at, dst):
    """One register pass, all groups at once as the kernel's threads run
    them: group v of a CTA is row v >> lg, q = v mod 2^lg (lg = log2 n - r),
    q = l 2^pw + p (l < 2^s0, pw = lg - s0); slot j reads index l 2^(L - s0)
    + j 2^pw + p of its row; stage s0 + b pairs slot j with j + 2^(r-1-b)
    under the segment l_b = brev_b(j >> (r - b)) 2^s0 + l's twiddle at
    2^(s0+b) - 1 + l_b of the table; slot j goes to index brev_r(j) 2^lg + q.
    Indices are CTA-local (row n + index); ``read_at``/``write_at`` map them
    to buffer positions (the swizzle or the identity)."""
    big_l = n.bit_length() - 1
    big_r, lg = 1 << r, big_l - r
    pw = lg - s0
    v = np.arange(rows << lg)
    row, q = v >> lg, v & ((1 << lg) - 1)
    l, p = q >> pw, q & ((1 << pw) - 1)
    i0 = row * n + (l << (big_l - s0)) + p
    pts = np.stack([src[:, read_at(i0 + (j << pw))] for j in range(big_r)], -1)
    for b in range(r):
        s, h = s0 + b, 1 << (r - 1 - b)
        for j in range(big_r):
            if j & h:
                continue
            w = tab[(1 << s) - 1 + (int(_brev(j >> (r - b), b)) << s0) + l]
            u, x = pts[..., j].copy(), pts[..., j + h].copy()
            tr = x.real * w.real - x.imag * w.imag
            ti = x.real * w.imag + x.imag * w.real
            pts[..., j] = (u.real + tr) + 1j * (u.imag + ti)
            pts[..., j + h] = (u.real - tr) + 1j * (u.imag - ti)
    o = row * n + q
    for j in range(big_r):
        dst[:, write_at(o + (int(_brev(j, r)) << lg))] = pts[..., j]


def _ctas(xr, xi, rows):
    b, n = xr.shape
    ctas = -(-b // rows)
    x = np.zeros((ctas * rows, n), np.complex64)
    x[:b] = (xr + 1j * xi).astype(np.complex64)
    return x.reshape(ctas, rows * n)  # CTA-local indices row n + index


def stockham_model(xr, xi, sign):
    """fft_stockham_lanes' kernel in float32 numpy: CTAs of
    ``stockham_geometry`` rows; the first pass reads the input in natural
    order, the last writes the output in natural order, and in between the
    points cross two exchange buffers (pass p writes buffer p mod 2)
    through the swizzle."""
    b, n = xr.shape
    rows = fk.stockham_geometry(n)[0]
    x = _ctas(xr, xi, rows)
    tab = fk.stockham_stage_table_np(n, sign).astype(np.complex64)
    out = np.full_like(x, np.nan)
    ex = [np.full_like(x, np.nan), np.full_like(x, np.nan)]
    passes = fk.stockham_passes(n)
    for k, (s0, r) in enumerate(passes):
        first, last = k == 0, k == len(passes) - 1
        src, read_at = (x, _plain) if first else (ex[(k + 1) % 2], _swizzle)
        dst, write_at = (out, _plain) if last else (ex[k % 2], _swizzle)
        _pass(src, read_at, s0, r, n, rows, tab, write_at, dst)
    out = out.reshape(-1, n)[:b]
    return out.real, out.imag


def ring_model(xr, xi, sign):
    """fft_stockham_manual's passes on one tile at a time: the slot holds
    the tile in natural order (as the bulk copy leaves it), pass p reads
    the slot for even p and the work tile for odd p and writes the other,
    through the swizzle except for the first pass's reads and the last
    pass's writes (natural order, for the bulk store).  Returns the result
    and whether it ended in the work tile."""
    b, n = xr.shape
    rows = fk.manual_ring(n)[0]
    slot = _ctas(xr, xi, rows)
    work = np.full_like(slot, np.nan)
    tab = fk.stockham_stage_table_np(n, sign).astype(np.complex64)
    bufs = [slot, work]
    passes = fk.stockham_passes(n)
    for k, (s0, r) in enumerate(passes):
        first, last = k == 0, k == len(passes) - 1
        _pass(bufs[k % 2], _plain if first else _swizzle, s0, r, n, rows, tab,
              _plain if last else _swizzle, bufs[(k + 1) % 2])
    in_work = len(passes) % 2 == 1
    out = bufs[1 if in_work else 0].reshape(-1, n)[:b]
    return out.real, out.imag, in_work


def _inputs(n, rows, seed):
    rng = np.random.default_rng(seed + n)
    b = rows + 1  # a full CTA or tile and a partial one
    return (rng.standard_normal((b, n)).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sign", SIGNS)
def test_stockham_pass_model_is_the_plain_version(n, sign):
    """The grid kernel's passes run every butterfly of the plain version
    with its operands: float32 results bit-equal to fft_stockham_lanes_ref,
    on a CTA's rows and one more (a partial last CTA); >= 100 dB against the
    JAX package's fft_stockham_lanes on the same inputs."""
    xr, xi = _inputs(n, fk.stockham_geometry(n)[0], 110)
    mr, mi = stockham_model(xr, xi, sign)
    pr, pi = fk.fft_stockham_lanes_ref(torch.as_tensor(xr), torch.as_tensor(xi), sign)
    assert np.array_equal(mr, pr.numpy()) and np.array_equal(mi, pi.numpy())
    jr, ji = jax_fk.fft_stockham_lanes(jnp.asarray(xr), jnp.asarray(xi), sign)
    assert _snr(np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64), mr + 1j * mi) >= 100.0


@pytest.mark.parametrize("n", RING_SIZES)
@pytest.mark.parametrize("sign", SIGNS)
def test_ring_pass_model_is_the_plain_version(n, sign):
    """The copy ring's passes, ping-ponging between the slot and the work
    tile, give the plain version bit for bit on a tile's rows and one more,
    and the result lies where the kernel's in_work says: the work tile for
    an odd number of passes (n = 2 to 16 and 512 to 4096), the slot for an
    even one (32 to 256, 8192)."""
    xr, xi = _inputs(n, fk.manual_ring(n)[0], 111)
    mr, mi, in_work = ring_model(xr, xi, sign)
    pr, pi = fk.fft_stockham_manual_ref(torch.as_tensor(xr), torch.as_tensor(xi), sign)
    assert np.array_equal(mr, pr.numpy()) and np.array_equal(mi, pi.numpy())
    big_l = n.bit_length() - 1
    assert in_work == (-(-big_l // 4) % 2 == 1)
    assert in_work == (n <= 16 or 512 <= n <= 4096)


@pytest.mark.parametrize("n", SIZES)
def test_passes_cover_every_stage_once(n):
    """Four stages a pass, a shorter last one, in order: at most
    ceil(log2 n / 4) - 1 barriers between passes (n = 1024: 4 + 4 + 2
    stages, 2 barriers where the radix-2 loop took 10)."""
    passes = fk.stockham_passes(n)
    big_l = n.bit_length() - 1
    assert [s for s0, r in passes for s in range(s0, s0 + r)] == list(range(big_l))
    assert all(r == 4 for _, r in passes[:-1]) and 1 <= passes[-1][1] <= 4
    assert len(passes) - 1 == -(-big_l // 4) - 1
    if n == 1024:
        assert passes == [(0, 4), (4, 4), (8, 2)]


# ---------------------------------------------------------------------------
# the exchange's banks
# ---------------------------------------------------------------------------

def _warp_accesses(n, rows, natural_ends):
    """Every warp access of the swizzled buffers at n, as CTA-local
    indices, one row of 32 per access: each pass's reads of slot j and
    writes of slot j, 32 consecutive groups a warp; the first pass's reads
    and the last pass's writes are left out (device memory in the grid
    kernel, the slot's natural order in the ring, ``natural_ends``)."""
    big_l = n.bit_length() - 1
    passes = fk.stockham_passes(n)
    swz, nat = [], []
    for k, (s0, r) in enumerate(passes):
        lg = big_l - r
        pw = lg - s0
        v = np.arange(rows << lg).reshape(-1, 32)
        row, q = v >> lg, v & ((1 << lg) - 1)
        l, p = q >> pw, q & ((1 << pw) - 1)
        reads = [row * n + (l << (big_l - s0)) + (j << pw) + p for j in range(1 << r)]
        writes = [row * n + (int(_brev(j, r)) << lg) + q for j in range(1 << r)]
        (nat if k == 0 else swz).extend(reads)
        (nat if k == len(passes) - 1 else swz).extend(writes)
    return (np.concatenate(swz) if swz else np.zeros((0, 32), int),
            np.concatenate(nat) if natural_ends else None)


def _conflict_free(idx):
    banks = np.sort(idx & 31, axis=1)
    return bool((np.diff(banks, axis=1) > 0).all())


@pytest.mark.parametrize("n", RING_SIZES)
@pytest.mark.parametrize("kernel", ("grid", "ring"))
def test_exchange_is_free_of_bank_conflicts(n, kernel):
    """Under the swizzle, each warp access of every pass to the exchange
    touches 32 distinct banks (4-byte planes: bank = index mod 32), in the
    grid kernel's CTAs (RADIX2_POINTS points) and the ring's tiles
    (ROW_POINTS points).  Without it the later passes' strided reads would
    collide (n = 1024, pass 2: p takes 4 values and l 8, 8 ways).  n <= 16
    runs one pass and has no exchange."""
    rows = (fk.stockham_geometry(n)[0] if kernel == "grid" else fk.manual_ring(n)[0])
    acc, _ = _warp_accesses(n, rows, False)
    assert (len(acc) > 0) == (n >= 32)
    if len(acc):
        assert _conflict_free(_swizzle(acc))
        assert n < 64 or not _conflict_free(acc)


def _ways(idx):
    """The worst bank conflict of a set of warp accesses: the most lanes
    that share a bank."""
    return max(np.bincount(row & 31, minlength=32).max() for row in idx)


def test_ring_natural_order_accesses():
    """The ring's slot is read in natural order by the first pass and the
    result written in natural order by the last (the bulk copies move
    planes as they are): conflict-free from n = 512 on, where a warp's 32
    groups are consecutive points; the small rows of a tile collide (n =
    16, one row a lane: 16 ways)."""
    for n in RING_SIZES:
        _, nat = _warp_accesses(n, fk.manual_ring(n)[0], True)
        assert (_ways(nat) == 1) == (n >= 512), n
    assert _ways(_warp_accesses(16, fk.manual_ring(16)[0], True)[1]) == 16


@pytest.mark.parametrize("n", RING_SIZES)
def test_swizzle_is_a_permutation_of_each_row(n):
    rows = fk.stockham_geometry(n)[0]
    i = np.arange(rows * n).reshape(rows, n)
    if n >= 32:
        assert np.array_equal(np.sort(_swizzle(i), axis=1), i)


def test_dit_swizzle_fails_the_stockham_reads():
    """Why the exchange reuses pease_swizzle and not dit_swizzle (bits 4..8
    and 9..13 into bits 0..4): the DIT map leaves the last pass's reads at
    n = 1024 (l over eight lanes at stride 4) in conflict."""
    def dit(i):
        return i ^ ((i >> 4) & 31) ^ ((i >> 9) & 31)

    acc, _ = _warp_accesses(1024, fk.stockham_geometry(1024)[0], False)
    assert not _conflict_free(dit(acc)) and _conflict_free(_swizzle(acc))


# ---------------------------------------------------------------------------
# launch geometry and wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << k for k in range(1, 25)])
def test_stockham_geometry_fits(n):
    """To 2^24: 16 points a thread of 256, the exchange buffers in shared
    memory within SMEM_LIMIT up to n = 8192 (the per-stage table stays in
    device memory), past it both buffers of the rows in scratch; every
    CTA-local index fits a 32-bit int."""
    rows, smem, scratch = fk.stockham_geometry(n)
    assert rows * n == max(n, fk.RADIX2_POINTS) and smem <= SMEM_LIMIT
    passes = len(fk.stockham_passes(n))
    if scratch == 0:
        assert smem == min(2, passes - 1) * 8 * rows * n
    assert (scratch > 0) == (n > 8192) and scratch in (0, 4 * rows * n)
    assert 4 * rows * n < 2 ** 31


@pytest.mark.parametrize("n", [1 << k for k in range(1, 25)])
def test_manual_ring_up_to_2_24(n):
    """The ring to 2^24: a tile is max(1, ROW_POINTS / n) rows, RING_DEPTH
    slots where they fit beside the work tile and a barrier per slot, 2 at
    n = 8192; past n = 8192 a ValueError naming SMEM_LIMIT."""
    if n > 8192:
        with pytest.raises(ValueError, match="SMEM_LIMIT"):
            fk.manual_ring(n)
        return
    rows, nbuf, smem = fk.manual_ring(n)
    assert rows == max(1, fk.ROW_POINTS // n) and smem <= SMEM_LIMIT
    assert nbuf == (2 if n == 8192 else fk.RING_DEPTH)
    assert smem == (nbuf + 1) * 8 * rows * n + 8 * nbuf


def test_wrapper_hands_its_own_table_and_geometry(monkeypatch):
    """Off the CPU fft_stockham_lanes launches with the Stockham per-stage
    table and its own geometry (no longer launch_geometry's)."""
    monkeypatch.delenv("ASP_SK_PIPE", raising=False)
    seen = []
    monkeypatch.setattr(fk, "_launch_complex", lambda fn, symbol, xr, xi, sign, tab=None,
                        geo=None: seen.append((fn, symbol, tab, geo)))
    x = torch.empty((2, 64), device="meta")
    fk.fft_stockham_lanes(x, x, -1.0)
    (fn, symbol, tab, geo), = seen
    assert fn is fk.fft_stockham_lanes and symbol == "asp_fft_stockham"
    assert tab is fk.stockham_table and geo is fk.stockham_geometry

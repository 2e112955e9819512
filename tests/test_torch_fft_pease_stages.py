"""The host side of fft_pease_lanes and fft_radix2_stages, redesigned for
Hopper, on the CPU.

- ``fft_pease_lanes`` runs its constant-geometry stages in registers, four
  a pass: its per-stage table (``pease_stage_table_np``) is held bit-equal
  in float32 to ``tw[(k >> s) << s]`` of the n/2-point table, and a numpy
  model of its passes (the points each thread holds, the per-stage table,
  the swizzled exchange, the bit reversal as the last pass's choice of
  points) is held bit-equal to ``fft_pease_lanes_ref`` and to the JAX
  package's ``fft_pease_lanes`` (interpret mode, >= 100 dB) at every n
  from 2 to 16384, both signs.
- Under the Pease exchange's swizzle every warp access of every pass (the
  strided reads, the consecutive writes, the last pass's bit-reversed
  reads) touches 32 banks at every n that runs in shared memory, and the
  swizzle permutes each row.
- ``fft_radix2_stages`` stages the n - 1 distinct entries of its stacked
  table into the per-stage layout (shifted by one entry, so that every
  copy is 16 aligned bytes of one row): bit-equal to
  ``radix2_stage_table_np``.
- Both launch geometries fit the card's shared memory or use scratch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.kernels import fft_kernel as jax_fk
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels._build import SMEM_LIMIT

SIZES = [1 << k for k in range(1, 15)]  # 2 to 16384
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


def _passes(n):
    """(s0, stages) of each pass: 4 stages each, the last one shorter."""
    big_l = n.bit_length() - 1
    return [(s0, min(4, big_l - s0)) for s0 in range(0, big_l, 4)]


# ---------------------------------------------------------------------------
# the per-stage table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sign", SIGNS)
def test_pease_stage_table_is_bit_equal(n, sign):
    """Stage s's entry k >> s, at offset n - n/2^s of the table the kernel
    receives, is tw[(k >> s) << s] of the n/2-point table (conjugated for
    the inverse) in float32, bit for bit, for every k < n/2."""
    t = fk.pease_stage_table_np(n, sign)
    assert t.shape == (n,) and t[-1] == 0
    got = fk.pease_table(n, -1 if sign < 0 else 1, torch.device("cpu")).numpy().view(np.complex64)
    tw = fk._twiddles_np(n).astype(np.complex64)
    if sign > 0:
        tw = tw.conj()
    k = np.arange(n // 2)
    for s in range(n.bit_length() - 1):
        have = got[n - (n >> s) + (k >> s)]
        assert np.array_equal(have.view(np.uint64), tw[(k >> s) << s].view(np.uint64))


# ---------------------------------------------------------------------------
# a model of the kernel's passes
# ---------------------------------------------------------------------------

def pease_model(xr, xi, sign):
    """fft_pease_lanes' passes in float32 numpy, all groups of a pass at
    once as the kernel's threads run them: CTAs of ``pease_geometry`` rows,
    R = 2^r points a group (r = 4, fewer in a shorter last pass); group v
    of a CTA is row v >> lg, q = v mod 2^lg (lg = log2 n - r), and takes g =
    q, or brev(q) in the last pass; slot t is read from index g + t n/R
    (the input in the first pass, else the exchange through the swizzle),
    the r stages run with the twiddles of the per-stage table, and slot j
    goes to index g R + j of the exchange, or in the last pass to natural
    index brev_r(j) n/R + q of the output."""
    b, n = xr.shape
    big_l = n.bit_length() - 1
    rows = fk.pease_geometry(n)[0]
    ctas = -(-b // rows)
    x = np.zeros((ctas * rows, n), np.complex64)
    x[:b] = (xr + 1j * xi).astype(np.complex64)
    x = x.reshape(ctas, rows * n)  # CTA-local indices row n + index
    tab = fk.pease_stage_table_np(n, sign).astype(np.complex64)
    ex = np.full_like(x, np.nan)
    out = np.full_like(x, np.nan)
    for s0, r in _passes(n):
        big_r, lg = 1 << r, big_l - r
        first, last = s0 == 0, s0 + r == big_l
        v = np.arange(rows << lg)
        row, q = v >> lg, v & ((1 << lg) - 1)
        g = _brev(q, lg) if last else q
        src = x if first else ex
        at = (lambda i: i) if first else _swizzle
        pts = np.stack([src[:, at(row * n + g + (t << lg))] for t in range(big_r)], -1)
        for b_ in range(r):
            ws = tab[n - (n >> (s0 + b_)):]
            h = 1 << (r - b_ - 1)
            for j in range(big_r):
                if j & h:
                    continue
                w = ws[(((j & (h - 1)) << lg) | g) >> s0]
                u, t = pts[..., j].copy(), pts[..., j + h].copy()
                dr, di = u.real - t.real, u.imag - t.imag
                pts[..., j] = (u.real + t.real) + 1j * (u.imag + t.imag)
                pts[..., j + h] = (dr * w.real - di * w.imag) + 1j * (dr * w.imag + di * w.real)
        new = np.full_like(ex, np.nan)
        for j in range(big_r):
            if last:
                out[:, row * n + (_brev(j, r) << lg) + q] = pts[..., j]
            else:
                new[:, _swizzle(row * n + g * big_r + j)] = pts[..., j]
        ex = new
    out = out.reshape(-1, n)[:b]
    return out.real, out.imag


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sign", SIGNS)
def test_pease_pass_model_is_the_plain_version(n, sign):
    """The kernel's passes run every butterfly of the plain version with
    its operands: float32 results bit-equal to fft_pease_lanes_ref, on a
    CTA's rows and one more (a partial last CTA); >= 100 dB against the
    JAX package's fft_pease_lanes on the same inputs."""
    rng = np.random.default_rng(100 + n)
    b = fk.pease_geometry(n)[0] + 1
    xr = rng.standard_normal((b, n)).astype(np.float32)
    xi = rng.standard_normal((b, n)).astype(np.float32)
    mr, mi = pease_model(xr, xi, sign)
    pr, pi = fk.fft_pease_lanes_ref(torch.as_tensor(xr), torch.as_tensor(xi), sign)
    assert np.array_equal(mr, pr.numpy()) and np.array_equal(mi, pi.numpy())
    jr, ji = jax_fk.fft_pease_lanes(jnp.asarray(xr), jnp.asarray(xi), sign)
    assert _snr(np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64), mr + 1j * mi) >= 100.0


# ---------------------------------------------------------------------------
# the exchange's banks
# ---------------------------------------------------------------------------

def _warp_accesses(n):
    """Every warp access of the exchange at n, as CTA-local indices, one
    row of 32 per access: a pass's reads of slot t (strided, bit-reversed
    groups in the last pass) and its writes of slot j (consecutive)."""
    big_l = n.bit_length() - 1
    rows = fk.pease_geometry(n)[0]
    passes = _passes(n)
    acc = []
    for s0, r in passes:
        lg = big_l - r
        first, last = s0 == 0, s0 + r == big_l
        v = np.arange(rows << lg).reshape(-1, 32)  # a warp: 32 consecutive groups
        row, q = v >> lg, v & ((1 << lg) - 1)
        g = _brev(q, lg) if last else q
        if not first:
            acc += [row * n + g + (t << lg) for t in range(1 << r)]
        if not last:
            acc += [row * n + (g << r) + j for j in range(1 << r)]
    return np.concatenate(acc)


SHARED = [n for n in SIZES if n >= 32 and fk.pease_geometry(n)[2] == 0]


@pytest.mark.parametrize("n", SHARED)
def test_pease_exchange_is_free_of_bank_conflicts(n):
    """Under the swizzle, each warp access of every pass touches 32
    distinct banks (4-byte planes: bank = index mod 32), at every n whose
    exchange runs in shared memory (n <= 16 runs one pass, no exchange)."""
    acc = _warp_accesses(n)
    assert len(acc) > 0
    banks = np.sort(_swizzle(acc) & 31, axis=1)
    assert (np.diff(banks, axis=1) > 0).all()
    # without the swizzle the consecutive writes would collide 16 ways
    plain = np.sort(acc & 31, axis=1)
    assert not (np.diff(plain, axis=1) > 0).all()


@pytest.mark.parametrize("n", SHARED)
def test_pease_swizzle_is_a_permutation_of_each_row(n):
    rows = fk.pease_geometry(n)[0]
    i = np.arange(rows * n).reshape(rows, n)
    assert np.array_equal(np.sort(_swizzle(i), axis=1), i)


# ---------------------------------------------------------------------------
# fft_radix2_stages' staging of its stacked table
# ---------------------------------------------------------------------------

def stages_staging(stacked):
    """fft_radix2_stages' shared-memory table as its CTA fills it: n/2
    16-byte copies, copy i putting row s's entries p = 2i - 2^s and p + 1
    (s = floor(log2 2i)) at entries 2i and 2i + 1, copy 0 row 0's first
    two; (the table, the rows' flat offsets of the copies)."""
    n = 2 * stacked.shape[1]
    i = np.arange(n // 2)
    s = np.where(i > 0, np.floor(np.log2(np.maximum(i, 1))).astype(int) + 1, 0)
    src = s * (n // 2) + 2 * i - np.where(i > 0, 1 << s, 0)
    flat = stacked.reshape(-1)
    return np.stack([flat[src], flat[src + 1]], 1).reshape(n), src


@pytest.mark.parametrize("n", SIZES[1:])
@pytest.mark.parametrize("sign", SIGNS)
def test_stages_staging_of_the_stacked_table_is_bit_equal(n, sign):
    """Read from entry 1 on (stage s at 2^s - 1 + 1), the table a CTA copies
    from the stacked table the kernel receives is radix2_stage_table_np's
    per-stage layout in float32, bit for bit: the n - 1 distinct entries
    (row s, p < 2^s).  Every copy reads 16 aligned bytes of one row (rows
    of at least two entries: n >= 4; the kernel stages from n = 32, where
    it runs a second pass)."""
    stacked = fk.stage_table(n, -1 if sign < 0 else 1, torch.device("cpu")).numpy()
    stacked = stacked.view(np.complex64).reshape(n.bit_length() - 1, n // 2)
    staged, src = stages_staging(stacked)
    want = fk.radix2_stage_table_np(n, sign)[: n - 1].astype(np.complex64)
    assert np.array_equal(staged[1:].view(np.uint64), want.view(np.uint64))
    assert (src % 2 == 0).all() and ((src % (n // 2)) + 1 < n // 2).all()


# ---------------------------------------------------------------------------
# launch geometry and wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << k for k in range(1, 25)])
def test_pease_geometry_fits(n):
    """To PEASE_MAX_N: 16 points a thread of 256, the table's later stages
    and the exchange buffers in shared memory within SMEM_LIMIT up to n =
    8192, past it both buffers of the rows in scratch."""
    rows, smem, scratch = fk.pease_geometry(n)
    assert rows * n == max(n, fk.RADIX2_POINTS) and smem <= SMEM_LIMIT
    passes = len(_passes(n))
    if scratch == 0:
        assert smem == (n // 2 if passes > 1 else 0) + min(2, passes - 1) * 8 * rows * n
    assert (scratch > 0) == (n > 8192) and scratch in (0, 4 * rows * n)
    assert n <= fk.PEASE_MAX_N


@pytest.mark.parametrize("n", [1 << k for k in range(1, 25)])
def test_stages_geometry_fits(n):
    """fft_radix2_stages runs in fft_radix2_lanes' geometry: its n staged
    entries and the planes fit SMEM_LIMIT or the planes go to scratch, and
    the stacked table's last index s n/2 + p fits a 32-bit int."""
    rows, smem, scratch = fk.radix2_lanes_geometry(n)
    assert smem <= SMEM_LIMIT and (smem == 0) == (scratch > 0)
    if smem:
        assert smem == 8 * n + 8 * rows * n
    assert (n.bit_length() - 1) * (n // 2) < 2 ** 31


@pytest.mark.parametrize("name,table,geometry", [
    ("fft_radix2_stages", "stage_table", "radix2_lanes_geometry"),
    ("fft_pease_lanes", "pease_table", "pease_geometry"),
])
def test_wrappers_hand_their_own_table(monkeypatch, name, table, geometry):
    """Off the CPU each wrapper launches with its own table and geometry:
    the stacked table (not the lanes kernel's per-stage one) for the stages
    kernel, the Pease per-stage table for the Pease kernel."""
    seen = []
    monkeypatch.setattr(fk, "_launch_complex", lambda fn, symbol, xr, xi, sign, tab=None,
                        geo=None: seen.append((fn, symbol, tab, geo)))
    x = torch.empty((2, 64), device="meta")
    getattr(fk, name)(x, x, -1.0)
    (fn, symbol, tab, geo), = seen
    assert fn is getattr(fk, name) and symbol == f"asp_{name}"
    assert tab is getattr(fk, table) and geo is getattr(fk, geometry)

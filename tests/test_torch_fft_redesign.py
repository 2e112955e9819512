"""The host side of the two FFT kernels redesigned for Hopper, on the CPU.

- ``fft_fourstep`` runs its DFT products on the tensor cores as 3-pass
  TF32 split products: its split tables (``fourstep_tc_tables_np``) are
  held to the TF32 grid and to float64, and a float32 numpy model of the
  kernel's arithmetic (operands rounded as ``cvt.rna.tf32`` rounds them,
  big x big + big x small + small x big, float32 sums) over the whole
  four-step transform is held to float64 (>= 110 dB) and to the JAX
  package's ``fft_fourstep`` in interpret mode (>= 100 dB).
- ``fft_radix2_lanes`` runs its stages in registers: its per-stage table
  (``radix2_stage_table_np``) is held bit-equal to ``stage_twiddles_np``
  in float32, and a numpy model of its passes (the points each thread
  holds, the bit reversal as the first pass's choice of points, the
  swizzled exchange) is held bit-equal to ``fft_radix2_lanes_ref``.
- Both kernels' launch geometries fit the card's shared memory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosignalprocess_tpu.kernels import fft_kernel as jax_fk
from audiosignalprocess_tpu_torch.kernels import fft_kernel as fk
from audiosignalprocess_tpu_torch.kernels._build import SMEM_LIMIT

SIZES = [1 << k for k in range(2, 15)]  # fft_fourstep's n, 4 to 16384


def _snr(ref, got):
    ref, got = np.asarray(ref, np.complex128), np.asarray(got, np.complex128)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(np.abs(ref - got) ** 2))


def _rna(x):
    """float32 x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest,
    ties away from zero, the low 13 mantissa bits cleared."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _low13(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32) & np.uint32(0x1FFF)


# ---------------------------------------------------------------------------
# fft_fourstep's split tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES + [1 << 16])
def test_fourstep_tables_are_split_tf32(n):
    """Every entry's big and small halves are TF32 values (low 13 mantissa
    bits zero), finite, and big + small is the float64 value within
    2^-21 (every entry has magnitude <= 1)."""
    n1, n2 = fk.fourstep_split(n)
    t = fk.fourstep_tc_tables_np(n)
    assert t.shape == (n2 + n1, 4) and t.dtype == np.float32
    assert np.isfinite(t).all()
    assert not _low13(t).any()
    w = np.concatenate([np.exp(-2j * np.pi * np.arange(m) / m) for m in (n2, n1)])
    got = (t[:, 0].astype(np.float64) + t[:, 1]) + 1j * (t[:, 2].astype(np.float64) + t[:, 3])
    assert np.abs(got.real - w.real).max() <= 2.0 ** -21
    assert np.abs(got.imag - w.imag).max() <= 2.0 ** -21


def test_tf32_round_matches_cvt_rna():
    """The host rounding (from float64) agrees with cvt.rna on float32
    inputs, ties away from zero included."""
    rng = np.random.default_rng(90)
    x = np.concatenate([rng.standard_normal(4000), [1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                                                    1 + 3 * 2.0 ** -11, 0.0, 2.0 ** -126]])
    x32 = x.astype(np.float32)
    assert np.array_equal(fk.tf32_round(x32.astype(np.float64)).astype(np.float32), _rna(x32))
    big, small = fk.tf32_split(x)
    assert not _low13(big.astype(np.float32)).any() and not _low13(small.astype(np.float32)).any()


def test_fourstep_tables_upload_once_per_size():
    a = fk.fourstep_tc_tables(1024, torch.device("cpu"))
    assert a is fk.fourstep_tc_tables(1024, torch.device("cpu"))
    assert np.array_equal(a.numpy(), fk.fourstep_tc_tables_np(1024))


# ---------------------------------------------------------------------------
# a float32 model of fft_fourstep's arithmetic
# ---------------------------------------------------------------------------

def _dense(t, m, sign):
    """The m x m split DFT table W_m^{(k n) mod m} from compact entries t
    (rows of (re big, re small, im big, im small)), conjugated for sign > 0."""
    e = np.outer(np.arange(m), np.arange(m)) % m
    s = 1.0 if sign < 0 else -1.0
    return (t[e, 0], t[e, 1], np.float32(s) * t[e, 2], np.float32(s) * t[e, 3])


def _mm3(a, bb, bs):
    """a (..., K) @ b (K, N) as the kernel forms it: a split in registers
    (cvt.rna), three TF32 products, float32 sums."""
    ab = _rna(a)
    as_ = _rna(a - ab)
    return (as_ @ bb) + (ab @ bs) + (ab @ bb)


def _mm1(a, bb, bs):
    """A single TF32 pass (big x big), which the kernel never runs."""
    return _rna(a) @ bb


def _cmm3(ar, ai, b, mm):
    br_b, br_s, bi_b, bi_s = b
    sr = mm(ar, br_b, br_s) + mm(ai, -bi_b, -bi_s)
    si = mm(ar, bi_b, bi_s) + mm(ai, br_b, br_s)
    return sr, si


def fourstep_model(xr, xi, sign, mm=_mm3):
    """fft_fourstep's arithmetic in float32 numpy: the column DFTs as split
    products (n1 >= 8) or float32 products from the n/2 twiddles (n1 < 8),
    the twiddle W_n^{c b}, the row DFTs as split products, the transpose."""
    b, n = xr.shape
    n1, n2 = fk.fourstep_split(n)
    t = fk.fourstep_tc_tables_np(n)
    tw = fk._twiddles_np(n).astype(np.complex64)
    full = np.concatenate([tw, -tw])  # W_n^m for m < n
    if sign > 0:
        full = full.conj()
    x = (xr + 1j * xi).astype(np.complex64).reshape(b, n1, n2)
    if n1 >= 8:
        # Y^T[b][c] = sum_a X[a][b] W_n1^{a c}: (n2 x n1)(n1 x n1)
        xt = x.transpose(0, 2, 1)
        yr, yi = _cmm3(np.ascontiguousarray(xt.real), np.ascontiguousarray(xt.imag),
                       _dense(t[n2:], n1, sign), mm)
        y = (yr + 1j * yi).astype(np.complex64).transpose(0, 2, 1)
    else:
        w1 = full[(np.outer(np.arange(n1), np.arange(n1)) % n1) * n2]  # W_n1^{a c}, [a, c]
        y = np.einsum("rab,ac->rcb", x, w1).astype(np.complex64)
    z = (y * full[np.outer(np.arange(n1), np.arange(n2))]).astype(np.complex64)
    sr, si = _cmm3(np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag),
                   _dense(t[:n2], n2, sign), mm)
    s = (sr + 1j * si).astype(np.complex64)  # (b, n1 = c, n2 = d)
    return s.transpose(0, 2, 1).reshape(b, n)


@pytest.mark.parametrize("n", (8, 512, 1024, 4096))
@pytest.mark.parametrize("sign", (-1.0, 1.0))
def test_fourstep_split_model_vs_float64_and_jax(n, sign):
    """The 3-pass split products keep float32 accuracy: >= 110 dB against
    the float64 transform and >= 100 dB against the JAX package's
    fft_fourstep (interpret mode) on the same float32 inputs."""
    rng = np.random.default_rng(91)
    xr = rng.standard_normal((3, n)).astype(np.float32)
    xi = rng.standard_normal((3, n)).astype(np.float32)
    got = fourstep_model(xr, xi, sign)
    z = xr.astype(np.float64) + 1j * xi
    ref = np.fft.fft(z) if sign < 0 else np.fft.ifft(z) * n
    assert _snr(ref, got) >= 110.0
    jr, ji = jax_fk.fft_fourstep(jnp.asarray(xr), jnp.asarray(xi), sign)
    assert _snr(np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64), got) >= 100.0


def test_fourstep_single_pass_would_miss_the_bar():
    """The split is what holds the bar: the same model with one TF32 pass
    (big x big only) falls far below 100 dB."""
    rng = np.random.default_rng(92)
    n = 1024
    xr = rng.standard_normal((2, n)).astype(np.float32)
    xi = rng.standard_normal((2, n)).astype(np.float32)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    assert _snr(ref, fourstep_model(xr, xi, -1.0, _mm1)) < 80.0
    assert _snr(ref, fourstep_model(xr, xi, -1.0)) >= 110.0


# ---------------------------------------------------------------------------
# fft_radix2_lanes' per-stage table and passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << k for k in range(1, 15)])
@pytest.mark.parametrize("sign", (-1.0, 1.0))
def test_radix2_stage_table_is_bit_equal(n, sign):
    """Stage s's 2^s entries at offset 2^s - 1 are stage_twiddles_np's row s
    cast to float32, bit for bit, in the table the kernel receives."""
    t = fk.radix2_stage_table_np(n, sign)
    assert t.shape == (n,) and t[-1] == 0
    up = fk.radix2_lanes_table(n, -1 if sign < 0 else 1, torch.device("cpu")).numpy()
    got = up.view(np.complex64)
    for s, row in enumerate(fk.stage_twiddles_np(n, sign)):
        m = 1 << s
        want = row[:m].astype(np.complex64)
        assert np.array_equal(got[m - 1: 2 * m - 1].view(np.uint64), want.view(np.uint64))


def _brev(v, bits):
    return int(f"{v:0{bits}b}"[::-1], 2) if bits else 0


def _swizzle(i):
    return i ^ ((i >> 4) & 31) ^ ((i >> 9) & 31)


def _dit_index(g, j, f, r):
    return ((g >> f) << (f + r)) | (j << f) | (g & ((1 << f) - 1))


def radix2_lanes_model(xr, xi, sign):
    """fft_radix2_lanes' passes in float32 numpy, group by group as the
    kernel's threads run them: R = min(16, n) points a group, passes of up
    to r = log2 R stages, the first loading x[v + k n/R] into slot brev_r(k)
    of group brev(v), the exchange addressed through the swizzle."""
    b, n = xr.shape
    big_l = n.bit_length() - 1
    r = min(4, big_l)
    rr = 1 << r
    lg = big_l - r
    tab = fk.radix2_stage_table_np(n, sign).astype(np.complex64)
    ex = np.zeros((b, n), np.complex64)
    x = (xr + 1j * xi).astype(np.complex64)
    out = np.zeros((b, n), np.complex64)
    s0 = 0
    while s0 < big_l:
        s1, first = min(s0 + r, big_l), s0 == 0
        f = s1 - r
        last = s1 == big_l
        new = ex.copy()
        for q in range(1 << lg):
            g = _brev(q, lg) if first else q
            if first:
                v = np.stack([x[:, q + (k << lg)] for k in range(rr)], axis=1)
                v = v[:, [_brev(j, r) for j in range(rr)]]
            else:
                v = np.stack([ex[:, _swizzle(_dit_index(g, j, f, r))] for j in range(rr)], axis=1)
            low = g & ((1 << f) - 1)
            for s in range(s0, s1):
                h = 1 << (s - f)
                for j in range(rr):
                    if j & h:
                        continue
                    w = tab[(1 << s) - 1 + (((j & (h - 1)) << f) | low)]
                    u, t = v[:, j].copy(), v[:, j + h].copy()
                    tr = t.real * w.real - t.imag * w.imag
                    ti = t.real * w.imag + t.imag * w.real
                    v[:, j] = (u.real + tr) + 1j * (u.imag + ti)
                    v[:, j + h] = (u.real - tr) + 1j * (u.imag - ti)
            for j in range(rr):
                i = _dit_index(g, j, f, r)
                if last:
                    out[:, i] = v[:, j]
                else:
                    new[:, _swizzle(i)] = v[:, j]
        ex = new
        s0 = s1
    return out.real, out.imag


@pytest.mark.parametrize("n", (2, 4, 8, 16, 32, 512, 1024, 2048))
@pytest.mark.parametrize("sign", (-1.0, 1.0))
def test_radix2_pass_model_is_the_plain_version(n, sign):
    """The kernel's pass structure runs every butterfly with the plain
    version's operands: float32 results bit-equal to fft_radix2_lanes_ref."""
    rng = np.random.default_rng(93)
    xr = rng.standard_normal((3, n)).astype(np.float32)
    xi = rng.standard_normal((3, n)).astype(np.float32)
    mr, mi = radix2_lanes_model(xr, xi, sign)
    pr, pi = fk.fft_radix2_lanes_ref(torch.as_tensor(xr), torch.as_tensor(xi), sign)
    assert np.array_equal(mr, pr.numpy()) and np.array_equal(mi, pi.numpy())


@pytest.mark.parametrize("n", [1 << k for k in range(5, 15)])
def test_radix2_swizzle_is_a_permutation_of_each_row(n):
    i = np.arange(n)
    assert np.array_equal(np.sort(_swizzle(i)), i)


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << k for k in range(2, 25)])
def test_fourstep_geometry_fits(n):
    """Every n fits the card: M a multiple of 32 grid rows, shared memory
    within SMEM_LIMIT, Z in device memory only past n1 = 128."""
    rows, smem, scratch = fk.fourstep_geometry(n)
    n1, n2 = fk.fourstep_split(n)
    assert rows * n1 % 32 == 0 and rows * n1 >= fk.FOURSTEP_GRID_ROWS
    assert 0 < smem <= SMEM_LIMIT
    assert (scratch > 0) == (n1 > 128)


@pytest.mark.parametrize("n", [1 << k for k in range(1, 25)])
def test_radix2_lanes_geometry_fits(n):
    rows, smem, scratch = fk.radix2_lanes_geometry(n)
    assert rows * n >= min(n, fk.RADIX2_POINTS) and smem <= SMEM_LIMIT
    assert (smem == 0) == (scratch > 0) == (n > 8192)

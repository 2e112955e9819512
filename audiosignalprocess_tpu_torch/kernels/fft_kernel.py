"""The standalone FFT kernels: the hand-written Hopper kernels
(``csrc/fft_kernel.cu``) and their plain PyTorch versions.

- ``fft_stockham_lanes(xr, xi, sign)``: batched complex FFT of planar
  (B, n) float32 rows, natural order in and out, unnormalized, sign -1
  forward and +1 inverse (the Stockham stages in registers, four a pass);
- ``rfft_stockham(x)``: batched real FFT, (B, n) -> planar (B, n/2+1):
  the even/odd pack z = x[0::2] + i x[1::2], an n/2-point complex FFT and
  the untangle, in one kernel;
- ``irfft_stockham(sr, si, n)``: the inverse, planar (B, n/2+1) -> (B, n),
  scaled 1/n in the kernel; the imaginary parts of bins 0 and n/2 are
  ignored, as torch.fft.irfft ignores them;
- ``fft_fourstep``, ``fft_radix2_lanes``, ``fft_radix2_stages`` and
  ``fft_pease_lanes``: the other complex FFTs of the JAX package's impl
  registry, same planar contract as ``fft_stockham_lanes``: the four-step
  factorization n = n1 n2 (n2 = min(128, n)) as two dense DFT products
  around a twiddle (on the tensor cores, 3-pass TF32 split products),
  radix-2 decimation in time (stages in registers, four a pass; the
  stages kernel reads the stacked per-stage table) and the
  constant-geometry Pease stages (in registers, four a pass);
- ``fft_stockham_manual(xr, xi, sign)``: ``fft_stockham_lanes``'
  transform fed by an explicit copy ring (``csrc/fft_manual_kernel.cu``:
  a persistent grid, bulk asynchronous copies under an mbarrier per
  slot); ``fft_stockham_lanes`` launches it instead of its own kernel
  when ``ASP_SK_PIPE=manual`` (the JAX package's switch, read at each
  call);
- ``fft_complex(x, sign, core)``: the complex-tensor adapter behind
  ``ops.fft``'s kernel impls (a direct DFT below n = 4).

The plain versions (``*_ref``) run each kernel's own algorithm in
PyTorch, not torch.fft: the self-sorting Stockham radix-2 stages (the JAX
package's ``_stockham_stages_r2``), the four-step products, the radix-2
DIT stages after a bit reversal, the Pease stages before one.  Each
wrapper runs its plain version for a CPU tensor and counts no launch; a
CUDA float32 tensor launches the kernel; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from audiosignalprocess_tpu_torch.kernels._build import (
    SMEM_LIMIT, check_cuda_f32, kernel_fn, launch, load, raise_on_error,
)
from audiosignalprocess_tpu_torch.ops.fft import bit_reverse_indices
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.profiling import kernel_wrapper
from audiosignalprocess_tpu_torch.utils.validate import check

ROW_POINTS = 1024
"""fft_stockham_manual's tile takes max(1, ROW_POINTS / n) rows of an
n-point transform: one thread per 16 points of a tile."""


def _pow2(n: int, least: int) -> None:
    check(n >= least and n & (n - 1) == 0, f"power-of-two n >= {least} required, got {n}")


FOURSTEP_GRID_ROWS = 64
"""fft_fourstep's CTA takes max(FOURSTEP_GRID_ROWS, n1) grid rows: an M of
two warp items of 32 rows on the tensor cores."""

RADIX2_POINTS = 4096
"""fft_radix2_lanes', fft_pease_lanes' and fft_stockham_lanes' CTA takes
max(1, RADIX2_POINTS / n) rows (rfft_stockham's and irfft_stockham's
max(1, RADIX2_POINTS / m) rows of their m = n/2-point transform): 256
threads of 16 points each."""

PEASE_MAX_N = 1 << 24
"""fft_pease_lanes' bound, kept from the JAX kernel (its f32 iota
twiddle exponent is exact below it)."""


@functools.lru_cache(maxsize=64)
def _twiddles_np(n: int) -> np.ndarray:
    """exp(-2 pi i k / n) for k < n/2, float64."""
    return np.exp(-2j * np.pi * np.arange(n // 2) / n)


def fourstep_split(n: int) -> tuple[int, int]:
    """fft_fourstep's (n1, n2): n2 = min(128, n) points along a grid row,
    n1 = n / n2 rows (the JAX kernel's ``_split_n``)."""
    n2 = min(128, n)
    return n // n2, n2


@functools.lru_cache(maxsize=64)
def dft_matrix_np(n: int, sign: float = -1.0) -> np.ndarray:
    """The n-point DFT matrix exp(sign 2 pi i ((j k) mod n) / n), float64,
    its angles reduced mod n as the JAX kernel's ``_np_coef`` reduces them."""
    k = np.arange(n)
    return np.exp(np.copysign(2.0, sign) * 1j * np.pi * (np.outer(k, k) % n) / n)


@functools.lru_cache(maxsize=64)
def fourstep_twiddles_np(n: int, sign: float = -1.0) -> np.ndarray:
    """fft_fourstep's twiddle grid W_n^{c b} = exp(sign 2 pi i c b / n),
    (n1, n2) float64 (c b < n: no reduction needed)."""
    n1, n2 = fourstep_split(n)
    cb = np.outer(np.arange(n1), np.arange(n2))
    return np.exp(np.copysign(2.0, sign) * 1j * np.pi * cb / n)


@functools.lru_cache(maxsize=64)
def stage_twiddles_np(n: int, sign: float) -> np.ndarray:
    """fft_radix2_stages' stacked table, (log2 n, n/2) complex float64:
    stage s (half-size m = 2^s) holds its m twiddles exp(sign i pi p / m)
    tiled n/(2m) times (the JAX package's ``_stage_twiddles``)."""
    halves = [1 << s for s in range(n.bit_length() - 1)]
    return np.stack([np.tile(np.exp(np.copysign(1.0, sign) * 1j * np.pi * np.arange(m) / m),
                             n // (2 * m)) for m in halves])


def tf32_round(x: np.ndarray) -> np.ndarray:
    """float64 values rounded to TF32's 11 significant bits, to nearest,
    ties away from zero (``cvt.rna.tf32``), as float64."""
    m, e = np.frexp(np.asarray(x, dtype=np.float64))
    return np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11, e)


def tf32_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """x as big + small, both on the TF32 grid (float32 exactly): big the
    nearest TF32 value, small the nearest to the remainder x - big."""
    big = tf32_round(x)
    return big, tf32_round(np.asarray(x, dtype=np.float64) - big)


@functools.lru_cache(maxsize=64)
def fourstep_tc_tables_np(n: int) -> np.ndarray:
    """fft_fourstep's split tables, (n2 + n1, 4) float32: the n2 values
    W_n2^j, then the n1 values W_n1^j (W_N^j = exp(-2 pi i j / N), from
    float64), each as (re big, re small, im big, im small).  The dense
    tables are W_N^{(k n) mod N}; the kernel gathers from these and
    conjugates for the inverse."""
    n1, n2 = fourstep_split(n)
    w = np.concatenate([_unit_roots(n2), _unit_roots(n1)])
    rb, rs = tf32_split(w.real)
    ib, is_ = tf32_split(w.imag)
    return np.stack([rb, rs, ib, is_], axis=1).astype(np.float32)


def _unit_roots(m: int) -> np.ndarray:
    return np.exp(-2j * np.pi * np.arange(m) / m)


@functools.lru_cache(maxsize=64)
def radix2_stage_table_np(n: int, sign: float) -> np.ndarray:
    """fft_radix2_lanes' per-stage table, n complex float64: stage s's 2^s
    twiddles exp(sign i pi p / 2^s) at offset 2^s - 1 (the rows of
    ``stage_twiddles_np`` without their tiling), then one zero so the
    table is a whole number of 16-byte copies."""
    return np.concatenate([*(row[: 1 << s] for s, row in enumerate(stage_twiddles_np(n, sign))),
                           [0.0]])


@functools.lru_cache(maxsize=64)
def stockham_stage_table_np(n: int, sign: float) -> np.ndarray:
    """fft_stockham_lanes' and fft_stockham_manual's per-stage table, n - 1
    complex float64: stage s's 2^s twiddles exp(sign i pi l / 2^s) at
    offset 2^s - 1, each the value of the n/2-point table at l << (log2 n -
    1 - s) (conjugated for sign > 0) that the plain version reads."""
    tw = _twiddles_np(n) if sign < 0 else _twiddles_np(n).conj()
    big_l = n.bit_length() - 1
    return np.concatenate([tw[np.arange(1 << s) << (big_l - 1 - s)] for s in range(big_l)])


@functools.lru_cache(maxsize=64)
def pease_stage_table_np(n: int, sign: float) -> np.ndarray:
    """fft_pease_lanes' per-stage table, n complex float64: stage s's
    n/2^(s+1) twiddles w_s[m 2^s] = exp(sign 2 pi i m 2^s / n) (m = k >> s
    of the stage's w_s[k]) at offset n - n/2^s, the values of the n/2-point
    table (conjugated for sign > 0), then one zero so the table is a whole
    number of 16-byte copies."""
    tw = _twiddles_np(n) if sign < 0 else _twiddles_np(n).conj()
    return np.concatenate([*(tw[np.arange(n >> (s + 1)) << s] for s in range(n.bit_length() - 1)),
                           [0.0]])


# ---------------------------------------------------------------------------
# plain versions: the kernels' algorithms in PyTorch
# ---------------------------------------------------------------------------

def fft_stockham_lanes_ref(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """Plain PyTorch version of ``fft_stockham_lanes``, any device and
    dtype: all log2(n) self-sorting Stockham radix-2 stages on planar
    (B, n) rows.  Stage t views a row as (Lt, R) with Lt = 2^t: the halves
    u, v of each length-R segment give u + w v and u - w v, w = exp(sign i
    pi l / Lt) for segment l, stacked as (2 Lt, R/2).  Natural order in
    and out."""
    b, n = xr.shape
    tw = _twiddles_np(n)
    if sign > 0:
        tw = tw.conj()
    lt, r = 1, n
    while r > 1:
        h = r // 2
        w = tw[np.arange(lt) * (n // (2 * lt))]
        wc = upload(w.real.copy(), xr.dtype, xr.device)[:, None]
        ws = upload(w.imag.copy(), xr.dtype, xr.device)[:, None]
        ar, ai = xr.reshape(b, lt, r), xi.reshape(b, lt, r)
        ur, ui, vr, vi = ar[..., :h], ai[..., :h], ar[..., h:], ai[..., h:]
        vr, vi = vr * wc - vi * ws, vr * ws + vi * wc
        xr = torch.cat([ur + vr, ur - vr], dim=1).reshape(b, n)
        xi = torch.cat([ui + vi, ui - vi], dim=1).reshape(b, n)
        lt, r = 2 * lt, h
    return xr, xi


def rfft_stockham_ref(x: torch.Tensor):
    """Plain PyTorch version of ``rfft_stockham``: pack, n/2-point Stockham
    stages, untangle X[k] = (Z[k] + conj Z[-k])/2 - i w^k (Z[k] - conj
    Z[-k])/2 with w = exp(-2 pi i / n); bin n/2 = Re Z[0] - Im Z[0]."""
    b, n = x.shape
    half = n // 2
    zr, zi = fft_stockham_lanes_ref(x[:, 0::2], x[:, 1::2], -1.0)
    rev = torch.as_tensor((-np.arange(half)) % half, device=x.device)
    cr, ci = zr[:, rev], -zi[:, rev]
    er, ei = 0.5 * (zr + cr), 0.5 * (zi + ci)
    or_, oi = 0.5 * (zi - ci), -0.5 * (zr - cr)
    w = _twiddles_np(n)
    wc, ws = (upload(a.copy(), x.dtype, x.device) for a in (w.real, w.imag))
    sr = torch.cat([er + wc * or_ - ws * oi, zr[:, :1] - zi[:, :1]], dim=1)
    si = torch.cat([ei + wc * oi + ws * or_, torch.zeros_like(zr[:, :1])], dim=1)
    return sr, si


def irfft_stockham_ref(sr: torch.Tensor, si: torch.Tensor, n: int):
    """Plain PyTorch version of ``irfft_stockham``: z[k] = E[k] + i O[k]
    with E = (S[k] + conj S[n/2-k])/2, O = (S[k] - conj S[n/2-k])/2
    w^-k, the n/2-point inverse Stockham stages, 1/(n/2), and the re/im
    interleave.  The imaginary parts of bins 0 and n/2 are dropped."""
    b = sr.shape[0]
    half = n // 2
    si = si.clone()
    si[:, 0] = 0.0
    si[:, half] = 0.0
    cr, ci = sr.flip(1)[:, :half], -si.flip(1)[:, :half]      # conj S[half - k]
    ar, ai = sr[:, :half], si[:, :half]
    er, ei = 0.5 * (ar + cr), 0.5 * (ai + ci)
    dr, di = 0.5 * (ar - cr), 0.5 * (ai - ci)
    w = _twiddles_np(n).conj()
    wc, ws = (upload(a.copy(), sr.dtype, sr.device) for a in (w.real, w.imag))
    or_, oi = dr * wc - di * ws, dr * ws + di * wc
    tr, ti = fft_stockham_lanes_ref(er - oi, ei + or_, 1.0)
    return torch.stack([tr, ti], dim=-1).reshape(b, n) / half


def _planar(a: np.ndarray, like: torch.Tensor):
    """A complex float64 table as (re, im) tensors of ``like``'s dtype and device."""
    return (upload(a.real.copy(), like.dtype, like.device),
            upload(a.imag.copy(), like.dtype, like.device))


def fft_fourstep_ref(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """Plain PyTorch version of ``fft_fourstep``, any device and dtype: the
    row viewed as the grid X[a, b] = x[a n2 + b] (n1, n2 = fourstep_split),
    the n1-point DFTs down its columns, the twiddle W_n^{c b}, the
    n2-point DFTs along its rows, each DFT a dense product against its
    table, and the transpose T[d, c] = S[n1 d + c] to natural order."""
    b, n = xr.shape
    n1, n2 = fourstep_split(n)
    f1r, f1i = _planar(dft_matrix_np(n1, sign), xr)
    f2r, f2i = _planar(dft_matrix_np(n2, sign), xr)
    twr, twi = _planar(fourstep_twiddles_np(n, sign), xr)
    ar, ai = xr.reshape(b, n1, n2), xi.reshape(b, n1, n2)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # TF32 keeps ~3 decimal digits
    try:
        yr = torch.matmul(f1r, ar) - torch.matmul(f1i, ai)
        yi = torch.matmul(f1r, ai) + torch.matmul(f1i, ar)
        zr, zi = yr * twr - yi * twi, yr * twi + yi * twr
        sr = torch.matmul(zr, f2r) - torch.matmul(zi, f2i)
        si = torch.matmul(zr, f2i) + torch.matmul(zi, f2r)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return sr.transpose(1, 2).reshape(b, n), si.transpose(1, 2).reshape(b, n)


def fft_radix2_stages_ref(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """Plain PyTorch version of ``fft_radix2_stages`` and
    ``fft_radix2_lanes``, any device and dtype: the bit-reversal
    permutation, then the log2(n) decimation-in-time stages of the classic
    C loop, stage s pairing x[g 2m + p] with x[g 2m + m + p] (m = 2^s)
    under exp(sign i pi p / m), read from ``stage_twiddles_np``.  (The
    lanes kernel reads the same float32 values from its per-stage table,
    ``radix2_stage_table_np``.)"""
    b, n = xr.shape
    rev = torch.as_tensor(bit_reverse_indices(n), device=xr.device)
    xr, xi = xr[:, rev], xi[:, rev]
    tr, ti = _planar(stage_twiddles_np(n, sign), xr)
    for s in range(n.bit_length() - 1):
        m = 1 << s
        g = n // (2 * m)
        wc, ws = tr[s].reshape(g, m), ti[s].reshape(g, m)
        ar, ai = xr.reshape(b, g, 2, m), xi.reshape(b, g, 2, m)
        er, ei = ar[:, :, 0], ai[:, :, 0]
        pr = ar[:, :, 1] * wc - ai[:, :, 1] * ws
        pi = ar[:, :, 1] * ws + ai[:, :, 1] * wc
        xr = torch.cat([er + pr, er - pr], dim=-1).reshape(b, n)
        xi = torch.cat([ei + pi, ei - pi], dim=-1).reshape(b, n)
    return xr, xi


fft_radix2_lanes_ref = fft_radix2_stages_ref
# fft_stockham_manual runs fft_stockham_lanes' stages: its copy ring changes
# where the rows wait, not what is computed
fft_stockham_manual_ref = fft_stockham_lanes_ref


def fft_pease_lanes_ref(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """Plain PyTorch version of ``fft_pease_lanes``, any device and dtype:
    log2(n) identical constant-geometry stages, u = A[:n/2], v = A[n/2:],
    A' = interleave(u + v, (u - v) w_s) with w_s[k] = exp(sign 2 pi i
    ((k >> s) << s) / n), then the bit reversal that restores natural
    order."""
    b, n = xr.shape
    h = n // 2
    k = np.arange(h)
    tw = _twiddles_np(n) if sign < 0 else _twiddles_np(n).conj()
    for s in range(n.bit_length() - 1):
        wc, ws = _planar(tw[(k >> s) << s], xr)
        ur, ui, vr, vi = xr[:, :h], xi[:, :h], xr[:, h:], xi[:, h:]
        dr, di = ur - vr, ui - vi
        xr = torch.stack([ur + vr, dr * wc - di * ws], dim=-1).reshape(b, n)
        xi = torch.stack([ui + vi, dr * ws + di * wc], dim=-1).reshape(b, n)
    rev = torch.as_tensor(bit_reverse_indices(n), device=xr.device)
    return xr[:, rev], xi[:, rev]


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

class FftArgs(ctypes.Structure):
    """The FFT kernels' arguments: ``struct FftArgs`` of
    ``csrc/fft_kernel.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "in_r", "in_i", "out_r", "out_i", "tw", "scratch", "table")]
        + [(name, ctypes.c_int) for name in ("batch", "n", "sign", "rows")])


def fourstep_geometry(n: int) -> tuple[int, int, int]:
    """(rows per CTA, dynamic shared memory, scratch floats per CTA) of
    fft_fourstep at n points, as the kernel lays them out
    (``fourstep_geo``): max(FOURSTEP_GRID_ROWS, n1) grid rows of Z, n2 + 8
    floats apart, per plane; the row table and (8 <= n1 <= 128) the column
    table in eight copies of 16 bytes an entry; the n/2 twiddles up to
    8192 points.  Above n1 = 128 Z goes to a scratch buffer in device
    memory (scratch > 0)."""
    n1, n2 = fourstep_split(n)
    n2p = max(8, n2)
    gm = max(FOURSTEP_GRID_ROWS, n1)
    z = 2 * gm * (n2p + 8)
    smem = (128 * n2p + (128 * n1 if 8 <= n1 <= 128 else 0) + (4 * n if n <= 8192 else 0)
            + (4 * z if n1 <= 128 else 0))
    return gm // n1, smem, 0 if n1 <= 128 else z


def radix2_lanes_geometry(n: int) -> tuple[int, int, int]:
    """(rows per CTA, dynamic shared memory, scratch floats per CTA) of
    fft_radix2_lanes at n points: the per-stage table (n complex) and the
    exchange planes of its rows (2 n floats a row) in shared memory where
    they fit, else the planes in a scratch buffer in device memory."""
    rows = max(1, RADIX2_POINTS // n)
    smem = 8 * n + 8 * rows * n
    if smem <= SMEM_LIMIT:
        return rows, smem, 0
    return rows, 0, 2 * rows * n


def pease_geometry(n: int) -> tuple[int, int, int]:
    """(rows per CTA, dynamic shared memory, scratch floats per CTA) of
    fft_pease_lanes at n points: RADIX2_POINTS points a CTA (16 a thread)
    in passes of 4 stages (a shorter last one); the per-stage table's
    entries past the first pass (n/16 complex) and the exchange buffers of
    its rows (two of 2 n floats a row; one for two passes, none for one) in
    shared memory where they fit, else both buffers in a scratch buffer in
    device memory and the table read from device memory."""
    rows = max(1, RADIX2_POINTS // n)
    passes = -(-(n.bit_length() - 1) // 4)
    bufs = min(2, passes - 1)
    smem = (8 * (n // 16) if passes > 1 else 0) + bufs * 8 * rows * n
    if smem <= SMEM_LIMIT:
        return rows, smem, 0
    return rows, 0, 4 * rows * n


def stockham_passes(n: int) -> list[tuple[int, int]]:
    """(first stage, stages) of each register pass of fft_stockham_lanes and
    fft_stockham_manual at n points: four stages a pass, a shorter last one
    where log2 n is not a multiple of 4 (n below 16 runs one pass of all its
    stages)."""
    big_l = n.bit_length() - 1
    return [(s0, min(4, big_l - s0)) for s0 in range(0, big_l, 4)]


def stockham_geometry(n: int, passes: int | None = None) -> tuple[int, int, int]:
    """(rows per CTA, dynamic shared memory, scratch floats per CTA) of
    fft_stockham_lanes at n points, in ``passes`` register passes (by
    default ``stockham_passes(n)``'s): RADIX2_POINTS points a CTA (16 a
    thread of 256); the exchange buffers of its rows (two of 2 n floats a
    row; one for two passes, none for one) in shared memory where they fit,
    else both in a scratch buffer in device memory.  The kernel reads its
    per-stage table from device memory."""
    rows = max(1, RADIX2_POINTS // n)
    passes = len(stockham_passes(n)) if passes is None else passes
    smem = min(2, passes - 1) * 8 * rows * n
    if smem <= SMEM_LIMIT:
        return rows, smem, 0
    return rows, 0, 4 * rows * n


def real_stockham_passes(n: int, inverse: bool = False) -> list[tuple[int, int]]:
    """(first stage, stages) of each register pass of rfft_stockham (or,
    ``inverse``, irfft_stockham) at n real points, on the m = n/2-point
    transform: passes of four stages and the untangle's pass of rs = log2 m
    mod 4 stages, whose groups go in pairs, last in rfft and first in
    irfft.  Where log2 m is a multiple of 4, rs = 1 and a pass of three
    takes the other stages of a fourth pass, first in rfft and second in
    irfft (where each keeps the exchange free of bank conflicts).  m <= 16
    runs one pass of all its stages."""
    big_l = (n // 2).bit_length() - 1
    if big_l <= 4:
        return [(0, big_l)]
    rs = big_l % 4 or 1
    mid = [3] if (big_l - rs) % 4 else []
    full = [4] * ((big_l - rs) // 4)
    sizes = [rs] + mid + full if inverse else mid + full + [rs]
    return [(sum(sizes[:i]), r) for i, r in enumerate(sizes)]


@functools.lru_cache(maxsize=64)
def real_stockham_geometry(n: int) -> tuple[int, int, int]:
    """(rows per CTA, dynamic shared memory, scratch floats per CTA) of
    rfft_stockham and irfft_stockham at n real points: ``stockham_geometry``
    of the m = n/2-point transform in ``real_stockham_passes(n)``'s passes
    (both kernels read their first pass from device memory and write their
    last there; scratch past m = 8192)."""
    return stockham_geometry(n // 2, len(real_stockham_passes(n)))


def _launch(name: str, what: str, in_r, in_i, out_r, out_i, batch: int, n: int,
            sign: int, dev: torch.device, table: torch.Tensor,
            geometry: tuple[int, int, int]) -> None:
    """Launch one of the kernels on ``batch`` rows (n is the row length the
    caller sees; ``table`` the kernel's own table, ``geometry`` its (rows,
    shared memory, scratch floats per CTA))."""
    check(0 < batch < 2 ** 31, f"{batch} rows: 1..2^31-1 per launch")
    rows, smem, per_cta = geometry
    tw = fft_twiddles(n, dev)
    scratch = (None if per_cta == 0 else
               torch.empty((-(-batch // rows), per_cta), dtype=torch.float32, device=dev))
    ptr = lambda t: None if t is None else t.data_ptr()
    args = FftArgs(ptr(in_r), ptr(in_i), ptr(out_r), ptr(out_i), tw.data_ptr(),
                   ptr(scratch), ptr(table), batch, n, sign, rows)
    launch(what, kernel_fn(name, 1), ctypes.byref(args), smem, dev.index,
           torch.cuda.current_stream(dev).cuda_stream)


def _pairs(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A complex float64 table as float32 (re, im) pairs on ``device``."""
    return upload(np.ascontiguousarray(a.astype(np.complex64).view(np.float32)),
                  torch.float32, device)


@functools.lru_cache(maxsize=32)
def fft_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i k / n), k < n/2, as float32 (re, im) pairs on
    ``device``, from float64, uploaded once per size."""
    return _pairs(_twiddles_np(max(n, 2)), device)


@functools.lru_cache(maxsize=32)
def fourstep_tc_tables(n: int, device: torch.device) -> torch.Tensor:
    """``fourstep_tc_tables_np(n)`` on ``device``, uploaded once per size
    (the kernel conjugates it for the inverse)."""
    return upload(fourstep_tc_tables_np(n), torch.float32, device)


@functools.lru_cache(maxsize=32)
def radix2_lanes_table(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """fft_radix2_lanes' per-stage table for ``sign`` as float32 (re, im)
    pairs, from float64, uploaded once per size and sign."""
    return _pairs(radix2_stage_table_np(n, sign), device)


@functools.lru_cache(maxsize=32)
def stockham_table(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """The Stockham kernels' per-stage table for ``sign`` as float32 (re,
    im) pairs, from float64, uploaded once per size and sign."""
    return _pairs(stockham_stage_table_np(n, sign), device)


@functools.lru_cache(maxsize=32)
def pease_table(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """fft_pease_lanes' per-stage table for ``sign`` as float32 (re, im)
    pairs, from float64, uploaded once per size and sign."""
    return _pairs(pease_stage_table_np(n, sign), device)


@functools.lru_cache(maxsize=32)
def stage_table(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """fft_radix2_stages' (log2 n, n/2) stacked stage table for ``sign``,
    float32 pairs from float64, uploaded once per size and sign."""
    return _pairs(stage_twiddles_np(n, sign), device)


def _launch_complex(fn, symbol: str, xr: torch.Tensor, xi: torch.Tensor, sign: float,
                    table, geometry):
    """Launch the complex kernel ``symbol`` on planar CUDA float32 rows and
    count it on ``fn``; ``table(n, sign, device)`` gives its own table,
    ``geometry(n)`` its own launch geometry."""
    name = fn.__name__
    check_cuda_f32(xr, name, "ops.fft routes float64 to torch.fft")
    b, n = xr.shape
    s = -1 if sign < 0 else 1
    xr, xi = xr.contiguous(), xi.contiguous()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch(symbol, name, xr, xi, yr, yi, b, n, s, xr.device, table(n, s, xr.device),
            geometry(n))
    fn.launches += 1
    return yr, yi


def _planar_pair(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    check(a.ndim == 2 and a.shape == b.shape,
          f"{name} takes two planar (B, n) tensors of one shape, got "
          f"{tuple(a.shape)} and {tuple(b.shape)}")
    check(a.device == b.device and a.dtype == b.dtype,
          f"{name}: both planes on one device with one dtype")


def _sk_pipe() -> str:
    """``ASP_SK_PIPE``, read at each call: ``auto`` (the grid kernel) or
    ``manual`` (the copy-ring kernel), the JAX package's values."""
    v = os.environ.get("ASP_SK_PIPE", "auto")
    check(v in ("auto", "manual"), f"ASP_SK_PIPE must be auto|manual, got {v!r}")
    return v


@kernel_wrapper
def fft_stockham_lanes(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """Batched complex FFT of planar (B, n) rows, n a power of two >= 2:
    (yr, yi), natural order, unnormalized; ``sign`` -1 forward, +1 inverse.

    A CPU tensor runs ``fft_stockham_lanes_ref``.  A CUDA float32 tensor
    launches the kernel: each thread holds 16 points of a row and runs four
    Stockham stages on them in registers, the points crossing shared memory
    between passes (``stockham_geometry``); twiddles from the per-stage
    table (``stockham_stage_table_np``).  Under ``ASP_SK_PIPE=manual`` it
    launches ``fft_stockham_manual`` instead and counts no launch of its
    own.  Any other tensor raises."""
    _planar_pair(xr, xi, "fft_stockham_lanes")
    _pow2(xr.shape[1], 2)
    pipe = _sk_pipe()
    if xr.device.type == "cpu":
        return fft_stockham_lanes_ref(xr, xi, sign)
    if pipe == "manual":
        return fft_stockham_manual(xr, xi, sign)
    return _launch_complex(fft_stockham_lanes, "asp_fft_stockham", xr, xi, sign,
                           stockham_table, stockham_geometry)


fft_stockham_lanes.launches = 0

RING_DEPTH = 3
"""fft_stockham_manual's ring slots where they fit (the JAX kernel's
``_SK_NBUF``); 2 where only two do."""


class FftManualArgs(ctypes.Structure):
    """fft_stockham_manual's arguments: ``struct FftManualArgs`` of
    ``csrc/fft_manual_kernel.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in ("in_r", "in_i", "out_r", "out_i", "tw")]
                + [(name, ctypes.c_int) for name in
                   ("batch", "n", "sign", "rows", "nbuf", "grid")])


def manual_ring(n: int) -> tuple[int, int, int]:
    """(rows per tile, ring slots, dynamic shared memory) of
    fft_stockham_manual at n points: ``RING_DEPTH`` slots of a tile's re
    and im planes where they fit, else 2, beside one work tile and a
    barrier per slot (the kernel reads its per-stage table from device
    memory).  Raises ValueError where not even a 2-slot ring of one row
    fits (n > 8192)."""
    rows = max(1, ROW_POINTS // n)

    def smem(nbuf):
        return (nbuf + 1) * 8 * rows * n + 8 * nbuf

    nbuf = RING_DEPTH if smem(RING_DEPTH) <= SMEM_LIMIT else 2
    check(smem(nbuf) <= SMEM_LIMIT,
          f"fft_stockham_manual: a 2-slot ring of {n}-point rows needs {smem(nbuf)} bytes of "
          f"shared memory, over SMEM_LIMIT = {SMEM_LIMIT} (n <= 8192)")
    return rows, nbuf, smem(nbuf)


@functools.lru_cache(maxsize=32)
def manual_ctas(n: int, device: torch.device) -> int:
    """The CTAs of fft_stockham_manual at n points that fit on the CUDA
    ``device`` at once (resident per SM times the SM count): its grid,
    where the batch has as many tiles."""
    index = torch.cuda.current_device() if device.index is None else device.index
    fn = load().asp_fft_manual_ctas
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows, nbuf, smem = manual_ring(n)
    args = FftManualArgs(None, None, None, None, None, 0, n, -1, rows, nbuf, 0)
    ctas = ctypes.c_int(0)
    raise_on_error(fn(ctypes.byref(args), smem, index, ctypes.byref(ctas)),
                   "fft_stockham_manual occupancy")
    return ctas.value


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte-aligned address (bulk copies need one): a
    view that starts elsewhere, such as ``x[1:]`` of 2-point rows, is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@kernel_wrapper
def fft_stockham_manual(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """``fft_stockham_lanes``' transform through the copy-ring kernel (the
    JAX package's ``ASP_SK_PIPE=manual`` form), n a power of two,
    2 <= n <= 8192: (yr, yi), natural order, unnormalized.

    A CPU tensor runs ``fft_stockham_manual_ref``.  A CUDA float32 tensor
    launches the kernel: a persistent grid whose CTAs walk the row tiles,
    each fetching its next tiles into a ring in shared memory with bulk
    asynchronous copies while it runs the register Stockham passes of
    ``fft_stockham_lanes`` on the current one.  Any other tensor raises,
    and so does a row too long for the ring (``manual_ring``), on every
    device, before dispatch."""
    _planar_pair(xr, xi, "fft_stockham_manual")
    b, n = xr.shape
    _pow2(n, 2)
    rows, nbuf, smem = manual_ring(n)
    if xr.device.type == "cpu":
        return fft_stockham_manual_ref(xr, xi, sign)
    check_cuda_f32(xr, "fft_stockham_manual", "ops.fft routes float64 to torch.fft")
    check(0 < b < 2 ** 31, f"{b} rows: 1..2^31-1 per launch")
    dev = xr.device
    xr, xi = _aligned(xr), _aligned(xi)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    grid = min(-(-b // rows), manual_ctas(n, dev))
    s = -1 if sign < 0 else 1
    args = FftManualArgs(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                         stockham_table(n, s, dev).data_ptr(), b, n, s, rows, nbuf, grid)
    launch("fft_stockham_manual", kernel_fn("asp_fft_stockham_manual", 1), ctypes.byref(args),
           smem, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    fft_stockham_manual.launches += 1
    return yr, yi


fft_stockham_manual.launches = 0


@kernel_wrapper
def rfft_stockham(x: torch.Tensor):
    """Batched real FFT, (B, n) -> (sr, si) of shape (B, n/2+1), n a power
    of two >= 4.

    A CPU tensor runs ``rfft_stockham_ref``.  A CUDA float32 tensor
    launches the kernel: ``fft_stockham_lanes``' register passes on the
    n/2-point rows (``real_stockham_passes``, ``real_stockham_geometry``),
    the even/odd pack in the first pass's loads and the untangle in the
    last pass's registers, two groups a thread whose bins mirror each
    other's; twiddles from the n/2-point per-stage table
    (``stockham_table``) and the n/2-point untangle table.  Any other
    tensor raises."""
    check(x.ndim == 2, f"rfft_stockham takes (B, n) rows, got {tuple(x.shape)}")
    b, n = x.shape
    _pow2(n, 4)
    if x.device.type == "cpu":
        return rfft_stockham_ref(x)
    check_cuda_f32(x, "rfft_stockham", "ops.fft routes float64 to torch.fft")
    x = _aligned(x)  # read as float2 pairs
    dev = x.device
    sr = torch.empty((b, n // 2 + 1), dtype=torch.float32, device=dev)
    si = torch.empty_like(sr)
    _launch("asp_rfft_stockham", "rfft_stockham", x, None, sr, si, b, n, -1, dev,
            stockham_table(n // 2, -1, dev), real_stockham_geometry(n))
    rfft_stockham.launches += 1
    return sr, si


rfft_stockham.launches = 0


@kernel_wrapper
def irfft_stockham(sr: torch.Tensor, si: torch.Tensor, n: int):
    """Batched inverse real FFT, planar (B, n/2+1) -> (B, n), scaled 1/n,
    n a power of two >= 4; the imaginary parts of bins 0 and n/2 are
    ignored.

    A CPU tensor runs ``irfft_stockham_ref``.  A CUDA float32 tensor
    launches the kernel: ``fft_stockham_lanes``' register passes on the
    n/2-point rows (``real_stockham_passes(n, inverse=True)``,
    ``real_stockham_geometry``), the untangle in the first pass's loads
    (two groups a thread, each bin read once), the scale and the re/im
    interleave in the last pass's stores.  Any other tensor raises."""
    _planar_pair(sr, si, "irfft_stockham")
    b, nb = sr.shape
    _pow2(n, 4)
    check(nb == n // 2 + 1, f"the spectrum must have n/2+1 = {n // 2 + 1} bins, got {nb}")
    if sr.device.type == "cpu":
        return irfft_stockham_ref(sr, si, n)
    check_cuda_f32(sr, "irfft_stockham", "ops.fft routes float64 to torch.fft")
    sr, si = sr.contiguous(), si.contiguous()
    dev = sr.device
    y = torch.empty((b, n), dtype=torch.float32, device=dev)
    _launch("asp_irfft_stockham", "irfft_stockham", sr, si, y, None, b, n, 1, dev,
            stockham_table(n // 2, 1, dev), real_stockham_geometry(n))
    irfft_stockham.launches += 1
    return y


irfft_stockham.launches = 0


@kernel_wrapper
def fft_fourstep(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """Batched complex FFT of planar (B, n) rows, n a power of two >= 4, by
    the four-step factorization (the JAX package's ``impl="pallas"``):
    (yr, yi), natural order, unnormalized; ``sign`` -1 forward, +1 inverse.

    A CPU tensor runs ``fft_fourstep_ref``.  A CUDA float32 tensor
    launches the kernel: each CTA takes ``fourstep_geometry(n)[0]`` rows as
    (n1, n2) grids and runs both DFT products on the tensor cores as
    3-pass TF32 split products (float32 accuracy; the column side in
    float32 FMAs below n1 = 8).  Any other tensor raises."""
    _planar_pair(xr, xi, "fft_fourstep")
    n = xr.shape[1]
    _pow2(n, 4)
    if xr.device.type == "cpu":
        return fft_fourstep_ref(xr, xi, sign)
    check_cuda_f32(xr, "fft_fourstep", "ops.fft routes float64 to torch.fft")
    # its rows reach shared memory by 16-byte asynchronous copies
    return _launch_complex(fft_fourstep, "asp_fft_fourstep", _aligned(xr), _aligned(xi), sign,
                           lambda n, s, dev: fourstep_tc_tables(n, dev), fourstep_geometry)


fft_fourstep.launches = 0


@kernel_wrapper
def fft_radix2_lanes(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """Batched complex FFT of planar (B, n) rows, n a power of two >= 2, by
    radix-2 decimation in time (the JAX package's ``impl="pallas_r2"``):
    the bit reversal, then every stage in one kernel, twiddle
    exp(sign i pi p / m) at half-size m.

    A CPU tensor runs ``fft_radix2_lanes_ref``.  A CUDA float32 tensor
    launches the kernel: each thread holds 16 points of a row and runs up
    to four stages on them in registers, the points crossing shared memory
    between groups of stages; the bit reversal is the first group's choice
    of points; twiddles from the per-stage table
    (``radix2_stage_table_np``).  Any other tensor raises."""
    _planar_pair(xr, xi, "fft_radix2_lanes")
    _pow2(xr.shape[1], 2)
    if xr.device.type == "cpu":
        return fft_radix2_lanes_ref(xr, xi, sign)
    return _launch_complex(fft_radix2_lanes, "asp_fft_radix2_lanes", xr, xi, sign,
                           radix2_lanes_table, radix2_lanes_geometry)


fft_radix2_lanes.launches = 0


@kernel_wrapper
def fft_radix2_stages(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """``fft_radix2_lanes``' transform with its twiddles read from the
    stacked per-stage table ``stage_twiddles_np`` (the JAX package's
    ``impl="pallas_r2_stages"``).

    A CPU tensor runs ``fft_radix2_stages_ref``.  A CUDA float32 tensor
    launches the kernel: ``fft_radix2_lanes``' register passes and launch
    geometry on the stacked table, whose n - 1 distinct entries a CTA
    stages into shared memory, so its result equals ``fft_radix2_lanes``'
    bit for bit.  Any other tensor raises."""
    _planar_pair(xr, xi, "fft_radix2_stages")
    _pow2(xr.shape[1], 2)
    if xr.device.type == "cpu":
        return fft_radix2_stages_ref(xr, xi, sign)
    return _launch_complex(fft_radix2_stages, "asp_fft_radix2_stages", xr, xi, sign,
                           stage_table, radix2_lanes_geometry)


fft_radix2_stages.launches = 0


@kernel_wrapper
def fft_pease_lanes(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """Batched complex FFT of planar (B, n) rows, n a power of two,
    2 <= n <= 2^24, by the constant-geometry (Pease) stages (the JAX
    package's ``impl="pallas_cg"``): natural order in and out.

    A CPU tensor runs ``fft_pease_lanes_ref``.  A CUDA float32 tensor
    launches the kernel: each thread holds 16 points of a row and runs four
    stages on them in registers, one pass body looped, the points crossing
    shared memory between passes (``pease_geometry``); the bit reversal is
    the last pass's choice of points; twiddles from the per-stage table
    (``pease_stage_table_np``).  Any other tensor raises."""
    _planar_pair(xr, xi, "fft_pease_lanes")
    n = xr.shape[1]
    _pow2(n, 2)
    check(n <= PEASE_MAX_N, f"fft_pease_lanes supports n <= 2^24, got {n}")
    if xr.device.type == "cpu":
        return fft_pease_lanes_ref(xr, xi, sign)
    return _launch_complex(fft_pease_lanes, "asp_fft_pease_lanes", xr, xi, sign, pease_table,
                           pease_geometry)


fft_pease_lanes.launches = 0


def fft_complex(x: torch.Tensor, sign: float, core=fft_fourstep) -> torch.Tensor:
    """Complex (..., n) -> complex (..., n) over one of the planar kernels
    (``core``; the JAX package's ``fft_complex`` adapter, whose default is
    its four-step kernel): a direct DFT for n < 4."""
    n = x.shape[-1]
    if n < 4:
        return x @ upload(dft_matrix_np(n, sign), x.dtype, x.device)
    rdt = torch.float64 if x.dtype == torch.complex128 else torch.float32
    xf = x.reshape(-1, n)
    yr, yi = core(xf.real.to(rdt).contiguous(), xf.imag.to(rdt).contiguous(), sign)
    return torch.complex(yr, yi).reshape(x.shape)

"""The standalone FFT kernels: the hand-written Hopper kernels
(``csrc/fft_kernel.cu``) and their plain PyTorch versions.

- ``fft_stockham_lanes(xr, xi, sign)``: batched complex FFT of planar
  (B, n) float32 rows, natural order in and out, unnormalized, sign -1
  forward and +1 inverse;
- ``rfft_stockham(x)``: batched real FFT, (B, n) -> planar (B, n/2+1):
  the even/odd pack z = x[0::2] + i x[1::2], an n/2-point complex FFT and
  the untangle, in one kernel;
- ``irfft_stockham(sr, si, n)``: the inverse, planar (B, n/2+1) -> (B, n),
  scaled 1/n in the kernel; the imaginary parts of bins 0 and n/2 are
  ignored, as torch.fft.irfft ignores them;
- ``fft_complex(x, sign)``: the complex-tensor adapter behind
  ``ops.fft``'s ``"stockham"`` impl (a direct DFT below n = 4).

The plain versions (``*_ref``) run the same self-sorting Stockham radix-2
stages in PyTorch (the JAX package's ``_stockham_stages_r2``), not
torch.fft.  Each wrapper runs its plain version for a CPU tensor and
counts no launch; a CUDA float32 tensor launches the kernel; anything else
raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audiosignalprocess_tpu_torch.kernels._build import (
    SMEM_LIMIT, check_cuda_f32, kernel_fn, raise_on_error,
)
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.validate import check

ROW_POINTS = 1024
"""A CTA takes max(1, ROW_POINTS / m) rows of an m-point transform, so
short transforms still give each CTA a few hundred butterflies per stage."""


def _pow2(n: int, least: int) -> None:
    check(n >= least and n & (n - 1) == 0, f"power-of-two n >= {least} required, got {n}")


@functools.lru_cache(maxsize=64)
def _twiddles_np(n: int) -> np.ndarray:
    """exp(-2 pi i k / n) for k < n/2, float64."""
    return np.exp(-2j * np.pi * np.arange(n // 2) / n)


# ---------------------------------------------------------------------------
# plain versions: the kernels' Stockham stages in PyTorch
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


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

class FftArgs(ctypes.Structure):
    """The FFT kernels' arguments: ``struct FftArgs`` of
    ``csrc/fft_kernel.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "in_r", "in_i", "out_r", "out_i", "tw", "scratch")]
        + [(name, ctypes.c_int) for name in ("batch", "n", "sign", "rows")])


def launch_geometry(m: int, table_n: int) -> tuple[int, int, bool]:
    """(rows per CTA, dynamic shared memory, in shared memory?) of an
    m-point transform with a table_n-point twiddle table: the twiddles
    (table_n/2 complex) and two ping-pong buffers of m complex points per
    row.  A transform too long for shared memory runs one row per CTA on
    ping-pong buffers in device memory."""
    rows = max(1, ROW_POINTS // m)
    smem = 8 * (table_n // 2) + 16 * m * rows
    if smem <= SMEM_LIMIT:
        return rows, smem, True
    return 1, 0, False


def _launch(name: str, what: str, in_r, in_i, out_r, out_i, batch: int, n: int,
            m: int, sign: int, dev: torch.device) -> None:
    """Launch one of the three kernels on ``batch`` rows of an m-point
    transform (n is the row length the caller sees)."""
    check(0 < batch < 2 ** 31, f"{batch} rows: 1..2^31-1 per launch")
    rows, smem, shared = launch_geometry(m, n)
    tw = fft_twiddles(n, dev)
    scratch = (None if shared else
               torch.empty((batch, 4 * m), dtype=torch.float32, device=dev))
    ptr = lambda t: None if t is None else t.data_ptr()
    args = FftArgs(ptr(in_r), ptr(in_i), ptr(out_r), ptr(out_i), tw.data_ptr(),
                   ptr(scratch), batch, n, sign, rows)
    rc = kernel_fn(name, 1)(ctypes.byref(args), smem, dev.index,
                            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, what)


@functools.lru_cache(maxsize=32)
def fft_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i k / n), k < n/2, as float32 (re, im) pairs on
    ``device``, from float64, uploaded once per size."""
    tw = _twiddles_np(max(n, 2)).astype(np.complex64).view(np.float32)
    return upload(np.ascontiguousarray(tw), torch.float32, device)


def _planar_pair(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    check(a.ndim == 2 and a.shape == b.shape,
          f"{name} takes two planar (B, n) tensors of one shape, got "
          f"{tuple(a.shape)} and {tuple(b.shape)}")
    check(a.device == b.device and a.dtype == b.dtype,
          f"{name}: both planes on one device with one dtype")


def fft_stockham_lanes(xr: torch.Tensor, xi: torch.Tensor, sign: float):
    """Batched complex FFT of planar (B, n) rows, n a power of two >= 2:
    (yr, yi), natural order, unnormalized; ``sign`` -1 forward, +1 inverse.

    A CPU tensor runs ``fft_stockham_lanes_ref``.  A CUDA float32 tensor
    launches the kernel: each CTA stages its rows in shared memory and runs
    the log2(n) Stockham stages there.  Any other tensor raises."""
    _planar_pair(xr, xi, "fft_stockham_lanes")
    b, n = xr.shape
    _pow2(n, 2)
    if xr.device.type == "cpu":
        return fft_stockham_lanes_ref(xr, xi, sign)
    check_cuda_f32(xr, "fft_stockham_lanes", "ops.fft routes float64 to torch.fft")
    xr, xi = xr.contiguous(), xi.contiguous()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("asp_fft_stockham", "fft_stockham", xr, xi, yr, yi, b, n, n,
            -1 if sign < 0 else 1, xr.device)
    fft_stockham_lanes.launches += 1
    return yr, yi


fft_stockham_lanes.launches = 0


def rfft_stockham(x: torch.Tensor):
    """Batched real FFT, (B, n) -> (sr, si) of shape (B, n/2+1), n a power
    of two >= 4.

    A CPU tensor runs ``rfft_stockham_ref``.  A CUDA float32 tensor
    launches the kernel (pack, n/2-point stages and untangle in one pass
    through shared memory).  Any other tensor raises."""
    check(x.ndim == 2, f"rfft_stockham takes (B, n) rows, got {tuple(x.shape)}")
    b, n = x.shape
    _pow2(n, 4)
    if x.device.type == "cpu":
        return rfft_stockham_ref(x)
    check_cuda_f32(x, "rfft_stockham", "ops.fft routes float64 to torch.fft")
    x = x.contiguous()
    sr = torch.empty((b, n // 2 + 1), dtype=torch.float32, device=x.device)
    si = torch.empty_like(sr)
    _launch("asp_rfft_stockham", "rfft_stockham", x, None, sr, si, b, n, n // 2, -1,
            x.device)
    rfft_stockham.launches += 1
    return sr, si


rfft_stockham.launches = 0


def irfft_stockham(sr: torch.Tensor, si: torch.Tensor, n: int):
    """Batched inverse real FFT, planar (B, n/2+1) -> (B, n), scaled 1/n,
    n a power of two >= 4; the imaginary parts of bins 0 and n/2 are
    ignored.

    A CPU tensor runs ``irfft_stockham_ref``.  A CUDA float32 tensor
    launches the kernel (untangle, n/2-point inverse stages, scale and
    interleave in one pass).  Any other tensor raises."""
    _planar_pair(sr, si, "irfft_stockham")
    b, nb = sr.shape
    _pow2(n, 4)
    check(nb == n // 2 + 1, f"the spectrum must have n/2+1 = {n // 2 + 1} bins, got {nb}")
    if sr.device.type == "cpu":
        return irfft_stockham_ref(sr, si, n)
    check_cuda_f32(sr, "irfft_stockham", "ops.fft routes float64 to torch.fft")
    sr, si = sr.contiguous(), si.contiguous()
    y = torch.empty((b, n), dtype=torch.float32, device=sr.device)
    _launch("asp_irfft_stockham", "irfft_stockham", sr, si, y, None, b, n, n // 2, 1,
            sr.device)
    irfft_stockham.launches += 1
    return y


irfft_stockham.launches = 0


@functools.lru_cache(maxsize=8)
def _dft_np(n: int, sign: float) -> np.ndarray:
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


def fft_complex(x: torch.Tensor, sign: float) -> torch.Tensor:
    """Complex (..., n) -> complex (..., n) over ``fft_stockham_lanes``
    (the JAX package's ``fft_complex`` adapter): a direct DFT for n < 4."""
    n = x.shape[-1]
    if n < 4:
        return x @ upload(_dft_np(n, sign), x.dtype, x.device)
    rdt = torch.float64 if x.dtype == torch.complex128 else torch.float32
    xf = x.reshape(-1, n)
    yr, yi = fft_stockham_lanes(xf.real.to(rdt).contiguous(),
                                xf.imag.to(rdt).contiguous(), sign)
    return torch.complex(yr, yi).reshape(x.shape)

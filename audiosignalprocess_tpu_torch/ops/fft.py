"""FFT family with the JAX package's pinned conventions.

Forward is unnormalized, the inverse scales by 1/N, ``rfft`` returns the
N/2+1 bins 0..N/2, and every transform runs on the last axis, whose
length must be a power of two (except under an explicit ``"torch"``).  The implementations, in the port's names
(the JAX package's in brackets):

- ``"torch"`` (``"xla"``): torch.fft;
- ``"radix2"``: iterative decimation in time with an explicit
  bit-reversal permutation, the classic C structure;
- ``"splitradix"``: recursive split-radix (L-shaped butterflies);
- ``"matmul"``: the four-step (Bailey) factorization n = n1*n2 as two
  dense DFT products around a twiddle, in plain torch (``torch.matmul``
  with TF32 off, DFT and twiddle tables from float64 on the host);
- ``"stockham"`` (``"pallas_sk"``): the hand-written Stockham kernels of
  ``kernels/fft_kernel``, complex through ``fft_stockham_lanes`` and real
  through the fused ``rfft_stockham`` / ``irfft_stockham``;
- ``"stockham_split"`` (``"pallas_sk_split"``): the even/odd pack and
  untangle of the real transforms in torch around the complex kernel;
- ``"fourstep"`` (``"pallas"``): the hand-written four-step kernel
  ``fft_fourstep`` (n1 x 128 grid, two dense DFT products on the tensor
  cores as 3-pass TF32 split products);
- ``"radix2_lanes"`` (``"pallas_r2"``): the hand-written radix-2 DIT
  kernel ``fft_radix2_lanes`` (up to four stages a pass in registers);
- ``"radix2_stages"`` (``"pallas_r2_stages"``): the same DIT passes on
  the stacked per-stage twiddle table, ``fft_radix2_stages`` (bit-equal
  to ``fft_radix2_lanes``);
- ``"pease"`` (``"pallas_cg"``): the hand-written constant-geometry
  kernel ``fft_pease_lanes`` (four stages a pass in registers, the bit
  reversal as the last pass's choice of points);
- ``"auto"`` (the default): ``"stockham"`` for a CUDA float32 or
  complex64 tensor, ``"torch"`` for anything else (CPU, float64).

The kernel wrappers run their plain PyTorch versions on a CPU tensor, so
every impl runs on the CPU.  Real transforms of every impl but
``"torch"`` (and ``"stockham"``'s fused real kernels) take the JAX
package's route: an n/2-point complex transform of z = x[0::2] +
i x[1::2] and the untangle.  ``irfft`` ignores the imaginary parts of
bins 0 and N/2, as torch.fft.irfft does.  An explicit ``"torch"`` takes
any length, as the JAX package's ``"xla"`` does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.validate import check

DEFAULT_IMPL = "auto"

_KERNEL_CORES = {
    "stockham": "fft_stockham_lanes",
    "stockham_split": "fft_stockham_lanes",
    "fourstep": "fft_fourstep",
    "radix2_lanes": "fft_radix2_lanes",
    "radix2_stages": "fft_radix2_stages",
    "pease": "fft_pease_lanes",
}
"""The impls that run a hand-written complex kernel (``kernels/fft_kernel``)."""

IMPLS = ("torch", "radix2", "splitradix", "matmul", *_KERNEL_CORES, "auto")

_JAX_NAMES = {"xla": "torch", "pallas_sk": "stockham", "pallas_sk_split": "stockham_split",
              "pallas": "fourstep", "pallas_r2": "radix2_lanes",
              "pallas_r2_stages": "radix2_stages", "pallas_cg": "pease"}
"""The JAX package's names of the port's impls."""


def _resolve_impl(impl: str, x: torch.Tensor) -> str:
    """A concrete impl for ``impl`` on ``x`` (``"auto"`` by device and dtype)."""
    impl = _JAX_NAMES.get(impl, impl)
    check(impl in IMPLS, f"unknown FFT impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        return ("stockham" if x.is_cuda and x.dtype in (torch.float32, torch.complex64)
                else "torch")
    return impl


def _check_pow2(n: int, least: int = 1) -> None:
    check(n >= least and n & (n - 1) == 0,
          f"power-of-two length >= {least} required, got {n}")


def _resolve_checked(impl: str, x: torch.Tensor, n: int, least: int = 1) -> str:
    """``_resolve_impl``, then the power-of-two check of length n.  An
    explicit ``"torch"`` (``"xla"``) skips the check and takes any length,
    as the JAX package's ``"xla"`` returns before its own; ``"auto"``
    checks even where it resolves to torch, as the JAX ``"auto"`` does."""
    explicit_torch = _JAX_NAMES.get(impl, impl) == "torch"
    impl = _resolve_impl(impl, x)
    if not explicit_torch:
        _check_pow2(n, least)
    return impl


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return (torch.complex128 if dtype in (torch.float64, torch.complex128)
            else torch.complex64)


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A float64 design-time table as ``like``'s complex dtype, on its device."""
    return upload(a, _complex_dtype(like.dtype), like.device)


# ---------------------------------------------------------------------------
# radix-2 (iterative DIT, explicit bit reversal) and split-radix
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bit_reverse_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation of a power-of-two n (``oracle.bit_reverse_indices``)."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _fft_radix2(x: torch.Tensor, sign: float) -> torch.Tensor:
    n = x.shape[-1]
    if n == 1:
        return x
    batch = x.shape[:-1]
    x = x[..., torch.as_tensor(bit_reverse_indices(n), device=x.device)]
    m = 1
    while m < n:
        w = _table(np.exp(sign * 1j * np.pi * np.arange(m) / m), x)
        xv = x.reshape(batch + (n // (2 * m), 2, m))
        a, b = xv[..., 0, :], xv[..., 1, :] * w
        x = torch.cat([a + b, a - b], dim=-1).reshape(batch + (n,))
        m *= 2
    return x


def _fft_splitradix(x: torch.Tensor, sign: float) -> torch.Tensor:
    n = x.shape[-1]
    if n == 1:
        return x
    if n == 2:
        return torch.stack([x[..., 0] + x[..., 1], x[..., 0] - x[..., 1]], dim=-1)
    u = _fft_splitradix(x[..., 0::2], sign)
    z = _fft_splitradix(x[..., 1::4], sign) * _table(
        np.exp(sign * 2j * np.pi * np.arange(n // 4) / n), x)
    zp = _fft_splitradix(x[..., 3::4], sign) * _table(
        np.exp(sign * 2j * np.pi * 3 * np.arange(n // 4) / n), x)
    s = z + zp
    d = (1j if sign > 0 else -1j) * (z - zp)
    uk, ukq = u[..., : n // 4], u[..., n // 4 :]
    return torch.cat([uk + s, ukq + d, uk - s, ukq - d], dim=-1)


# ---------------------------------------------------------------------------
# four-step matmul (the JAX package's _fft_matmul_planar)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dft_mat(n: int, sign: float) -> tuple[np.ndarray, np.ndarray]:
    """DFT matrix exp(sign*2j*pi*jk/n) as (real, imag) float64."""
    ang = sign * 2.0 * np.pi * np.outer(np.arange(n), np.arange(n)) / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=None)
def _fourstep_tw(n1: int, n2: int, sign: float) -> tuple[np.ndarray, np.ndarray]:
    """Twiddles W_n^{cb} of the four-step transform as (real, imag) float64."""
    ang = sign * 2.0 * np.pi * np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2)
    return np.cos(ang), np.sin(ang)


def _split_n(n: int) -> tuple[int, int]:
    """Balanced power-of-two factorization n = n1*n2 (n1 <= n2)."""
    k = n.bit_length() - 1
    return 1 << (k // 2), 1 << (k - k // 2)


def _fft_matmul(x: torch.Tensor, sign: float) -> torch.Tensor:
    """Four-step FFT on the last axis, n = n1*n2.  With n = n2*a + b and
    k = n1*d + c: Y[c,b] = sum_a F_n1[c,a] X[a,b]; Z = Y * W_n^{cb};
    out[c,d] = sum_b Z[c,b] F_n2[b,d]; natural order is the transpose
    (d, c).  Planar real products, as the JAX package's einsums."""
    n = x.shape[-1]
    if n == 1:
        return x
    rdt = torch.float64 if x.dtype == torch.complex128 else torch.float32
    n1, n2 = _split_n(n)
    tab = lambda pair: [upload(a, rdt, x.device) for a in pair]
    f1r, f1i = tab(_dft_mat(n1, sign))
    f2r, f2i = tab(_dft_mat(n2, sign))
    twr, twi = tab(_fourstep_tw(n1, n2, sign))
    batch = x.shape[:-1]
    xr = x.real.reshape(batch + (n1, n2))
    xi = x.imag.reshape(batch + (n1, n2))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # TF32 keeps ~3 decimal digits
    try:
        yr = torch.matmul(f1r, xr) - torch.matmul(f1i, xi)
        yi = torch.matmul(f1r, xi) + torch.matmul(f1i, xr)
        zr = yr * twr - yi * twi
        zi = yr * twi + yi * twr
        outr = torch.matmul(zr, f2r) - torch.matmul(zi, f2i)
        outi = torch.matmul(zr, f2i) + torch.matmul(zi, f2r)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.complex(outr.transpose(-1, -2).reshape(batch + (n,)),
                         outi.transpose(-1, -2).reshape(batch + (n,)))


def _kernel_fft(core: str):
    """The complex transform of a kernel impl: ``fft_complex`` over the
    kernel wrapper named ``core``, looked up at each call."""
    def run(x: torch.Tensor, sign: float) -> torch.Tensor:
        from audiosignalprocess_tpu_torch.kernels import fft_kernel

        return fft_kernel.fft_complex(x, sign, core=getattr(fft_kernel, core))
    return run


_COMPLEX = {"radix2": _fft_radix2, "splitradix": _fft_splitradix, "matmul": _fft_matmul,
            **{impl: _kernel_fft(core) for impl, core in _KERNEL_CORES.items()}}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def fft(x: torch.Tensor, impl: str = DEFAULT_IMPL) -> torch.Tensor:
    """Forward FFT on the last axis (unnormalized)."""
    impl = _resolve_checked(impl, x, x.shape[-1])
    if impl == "torch":
        return torch.fft.fft(x)
    return _COMPLEX[impl](x.to(_complex_dtype(x.dtype)), -1.0)


def ifft(x: torch.Tensor, impl: str = DEFAULT_IMPL) -> torch.Tensor:
    """Inverse FFT on the last axis, scaled 1/N."""
    n = x.shape[-1]
    impl = _resolve_checked(impl, x, n)
    if impl == "torch":
        return torch.fft.ifft(x)
    return _COMPLEX[impl](x.to(_complex_dtype(x.dtype)), 1.0) / n


def rfft(x: torch.Tensor, impl: str = DEFAULT_IMPL) -> torch.Tensor:
    """Real FFT on the last axis: N/2+1 bins."""
    check(not x.is_complex(),
          "rfft requires a real-valued input (use fft for complex signals)")
    n = x.shape[-1]
    impl = _resolve_checked(impl, x, n, least=2)
    if impl == "torch":
        return torch.fft.rfft(x)
    half = n // 2
    if impl == "stockham" and n >= 4:
        from audiosignalprocess_tpu_torch.kernels import fft_kernel

        yr, yi = fft_kernel.rfft_stockham(x.reshape(-1, n))
        return torch.complex(yr, yi).reshape(x.shape[:-1] + (half + 1,))
    cdt = _complex_dtype(x.dtype)
    if half == 1:
        a, b = x[..., 0], x[..., 1]
        return torch.stack([a + b, a - b], dim=-1).to(cdt)
    zf = _COMPLEX[impl](torch.complex(x[..., 0::2], x[..., 1::2]).to(cdt), -1.0)
    zk = torch.cat([zf, zf[..., :1]], dim=-1)
    zkc = zk.flip(-1).conj()
    xe = 0.5 * (zk + zkc)
    xo = -0.5j * (zk - zkc)
    return xe + _table(np.exp(-2j * np.pi * np.arange(half + 1) / n), xe) * xo


def irfft(spec: torch.Tensor, n: int, impl: str = DEFAULT_IMPL) -> torch.Tensor:
    """Inverse real FFT: n real samples from n/2+1 bins (1/N scaling)."""
    impl = _resolve_checked(impl, spec, n, least=2)
    if impl == "torch":
        return torch.fft.irfft(spec, n)
    half = n // 2
    cdt = _complex_dtype(spec.dtype)
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    sf = spec[..., : half + 1].to(cdt)
    if impl == "stockham" and n >= 4:
        from audiosignalprocess_tpu_torch.kernels import fft_kernel

        flat = sf.reshape(-1, half + 1)
        y = fft_kernel.irfft_stockham(flat.real.contiguous(), flat.imag.contiguous(), n)
        return y.reshape(spec.shape[:-1] + (n,))
    if half == 1:
        a, b = sf[..., 0].real, sf[..., 1].real
        return (torch.stack([a + b, a - b], dim=-1) * 0.5).to(rdt)
    # bins 0 and n/2 of a real signal's spectrum are real: their imaginary
    # parts are dropped, as torch.fft.irfft drops them
    edge = np.ones(half + 1)
    edge[[0, half]] = 0.0
    zk = torch.complex(sf.real, sf.imag * upload(edge, rdt, sf.device))
    zkc = zk.flip(-1).conj()
    xe = 0.5 * (zk + zkc)
    xo = 0.5 * (zk - zkc) * _table(np.exp(2j * np.pi * np.arange(half + 1) / n), zk)
    zt = _COMPLEX[impl]((xe + 1j * xo)[..., :half], 1.0) / half
    return torch.stack([zt.real, zt.imag], dim=-1).reshape(spec.shape[:-1] + (n,))


def fft_flops(n: int) -> float:
    """Nominal real-FLOP count of a radix-2 complex FFT (5 N log2 N)."""
    return 5.0 * n * math.log2(n)

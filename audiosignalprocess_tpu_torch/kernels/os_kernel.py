"""Fused overlap-save FIR: the hand-written Hopper kernel
(``csrc/os_kernel.cu``) and its plain PyTorch version.

Semantics of ``ops.overlap_save.overlap_save`` (the oracle-pinned causal
FIR, output length == input length, optional (..., T-1) history) and of
the JAX package's ``kernels/os_kernel.overlap_save_fused``; the block is
exactly nfft - (T-1), with no row alignment.

Routing: a CPU tensor runs ``overlap_save_ref``; a CUDA float32 tensor
launches the kernel; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audiosignalprocess_tpu_torch.kernels import _build
from audiosignalprocess_tpu_torch.kernels._build import (
    SMEM_LIMIT, check_cuda_f32, raise_on_error, rows_view,
)
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.validate import check


@functools.lru_cache(maxsize=32)
def fft_tables(h_bytes: bytes, nfft: int, device: torch.device):
    """(tap spectrum, twiddles) on ``device``, float32 pairs, uploaded
    once per filter: the full nfft-point spectrum of the zero-padded taps
    and the nfft/2 twiddles exp(-2 pi i k / nfft), both from float64."""
    h = np.frombuffer(h_bytes, dtype=np.float64)
    hf = np.fft.fft(np.concatenate([h, np.zeros(nfft - len(h))]))
    tw = np.exp(-2j * np.pi * np.arange(nfft // 2) / nfft)
    as_pairs = lambda a: upload(a.astype(np.complex64).view(np.float32),
                                torch.float32, device)
    return as_pairs(hf), as_pairs(tw)


def check_os_geometry(nfft: int, taps: int) -> None:
    check(nfft >= 2 and nfft & (nfft - 1) == 0, f"nfft={nfft} must be a power of two")
    check(nfft > taps - 1, f"nfft={nfft} must exceed taps-1 ({taps - 1})")


def overlap_save_ref(x: torch.Tensor, h, nfft: int,
                     history: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``ops.overlap_save.overlap_save`` with
    torch.fft (``impl="torch"``), any device and dtype."""
    return overlap_save(x, h, nfft, history=history, impl="torch")


@functools.cache
def _lib():
    fn = _build.load().asp_overlap_save
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def overlap_save_fused(x: torch.Tensor, h, nfft: int,
                       history: torch.Tensor | None = None) -> torch.Tensor:
    """Causal FIR by overlap-save at FFT size ``nfft``, fused.

    A CPU tensor runs ``overlap_save_ref``.  A CUDA float32 tensor
    launches the kernel: one CTA per (pair of blocks, channel), the two
    blocks as re/im of one complex transform.  Any other tensor raises.
    """
    h = np.ascontiguousarray(h, dtype=np.float64)
    t = len(h)
    check_os_geometry(nfft, t)
    if x.device.type == "cpu":
        return overlap_save_ref(x, h, nfft, history)
    check_cuda_f32(x, "overlap_save_fused",
                   "FIRStage routes float64 to the plain overlap_save")
    x2d, x_ld = rows_view(x)
    channels, n = x2d.shape
    check(n >= 1 and 0 < channels <= 65535,
          f"overlap_save_fused takes 1..65535 channels of >= 1 sample, "
          f"got {tuple(x2d.shape)}")
    hist = None
    if history is not None and t > 1:
        hist = history.reshape(channels, t - 1).contiguous()
        check(hist.dtype == torch.float32 and hist.device == x.device,
              "history must be float32 on the input's device")
    smem = 12 * nfft  # twiddles (nfft/2 complex) and the FFT buffer (nfft complex)
    check(smem <= SMEM_LIMIT, f"nfft={nfft} needs {smem} bytes of shared memory")
    dev = x.device
    hf, tw = fft_tables(h.tobytes(), nfft, dev)
    y = torch.empty((channels, n), dtype=torch.float32, device=dev)
    rc = _lib()(x2d.data_ptr(), x_ld, None if hist is None else hist.data_ptr(),
                y.data_ptr(), hf.data_ptr(), tw.data_ptr(), channels, n, nfft,
                nfft.bit_length() - 1, t, smem, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "overlap_save")
    overlap_save_fused.launches += 1
    return y.reshape(x.shape)


overlap_save_fused.launches = 0

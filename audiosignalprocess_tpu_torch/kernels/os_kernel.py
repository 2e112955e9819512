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
    SMEM_LIMIT, check_cuda_f32, launch, rows_view,
)
from audiosignalprocess_tpu_torch.kernels.fft_kernel import stockham_table
from audiosignalprocess_tpu_torch.kernels.gate_kernel import regs_info
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.profiling import kernel_wrapper
from audiosignalprocess_tpu_torch.utils.validate import check


OS_THREADS = 64
"""Threads of a CTA up to nfft 1024 (``kOsThreads`` of ``csrc/os_kernel.cu``):
one transform of 1024 points a CTA, or several smaller ones."""

OS_BIG_THREADS = 1024
"""Threads of the one transform of a CTA at nfft 16384 (``kOsBigThreads``)."""


@functools.lru_cache(maxsize=32)
def tap_spectrum(h_bytes: bytes, nfft: int, device: torch.device) -> torch.Tensor:
    """The full nfft-point spectrum of the zero-padded taps on ``device``,
    float32 (re, im) pairs from float64, uploaded once per filter."""
    h = np.frombuffer(h_bytes, dtype=np.float64)
    hf = np.fft.fft(np.concatenate([h, np.zeros(nfft - len(h))]))
    return upload(hf.astype(np.complex64).view(np.float32), torch.float32, device)


def os_geometry(nfft: int) -> dict:
    """The kernel's launch at FFT size ``nfft`` (``asp::os_regs``): points a
    thread (nfft below 16, 16 up to 8192, 16384 / OS_BIG_THREADS past it),
    threads a CTA (OS_THREADS, or nfft / points where one transform takes
    more), transforms a batch (a CTA's units), whether the CTA has one
    exchange buffer (one transform of more than 4096 points) and its
    dynamic shared memory: the exchange buffers (two planes of threads x
    points floats each) and a 16-byte entry a unit.  Past nfft 16384 the
    exchange buffer alone is more than SMEM_LIMIT: a ValueError names it."""
    check(nfft >= 2 and nfft & (nfft - 1) == 0, f"nfft={nfft} must be a power of two")
    points = nfft if nfft < 16 else 16 if nfft <= 8192 else nfft // OS_BIG_THREADS
    threads = max(OS_THREADS, nfft // points)
    batch = threads * points // nfft
    one = threads * points > 4096
    smem = 4 * (2 if one else 4) * threads * points + 16 * batch
    check(smem <= SMEM_LIMIT,
          f"nfft={nfft}: one transform of the overlap-save kernel is {nfft} points of "
          f"exchange in shared memory, {smem} bytes per block, more than SMEM_LIMIT "
          f"({SMEM_LIMIT} bytes); nfft <= 16384")
    return dict(points=points, threads=threads, batch=batch, one=one, smem=smem)


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
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@kernel_wrapper
def overlap_save_fused(x: torch.Tensor, h, nfft: int,
                       history: torch.Tensor | None = None) -> torch.Tensor:
    """Causal FIR by overlap-save at FFT size ``nfft``, fused.

    A CPU tensor runs ``overlap_save_ref``.  A CUDA float32 tensor
    launches the kernel: a CTA per batch of units (a channel's pair of
    blocks as re/im of one complex transform, units numbered across
    channels; ``os_geometry``) on register Stockham passes.  Any other
    tensor raises.
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
    smem = os_geometry(nfft)["smem"]
    dev = x.device
    hf = tap_spectrum(h.tobytes(), nfft, dev)
    y = torch.empty((channels, n), dtype=torch.float32, device=dev)
    launch("overlap_save", _lib(), x2d.data_ptr(), x_ld,
           None if hist is None else hist.data_ptr(), y.data_ptr(), hf.data_ptr(),
           stockham_table(nfft, -1, dev).data_ptr(), stockham_table(nfft, 1, dev).data_ptr(),
           channels, n, nfft, nfft.bit_length() - 1, t, smem, dev.index,
           torch.cuda.current_stream(dev).cuda_stream)
    overlap_save_fused.launches += 1
    return y.reshape(x.shape)


overlap_save_fused.launches = 0


def overlap_save_info(nfft: int = 1024, device: torch.device | None = None) -> dict:
    """The built kernel's instantiation for nfft, from the CUDA runtime:
    registers a thread, local memory bytes a thread (spills) and resident
    CTAs an SM, with the launch's threads and shared memory."""
    geo = os_geometry(nfft)
    dev = torch.device("cuda") if device is None else device
    return dict(regs_info("asp_overlap_save_info", nfft, None, geo["smem"], dev),
                threads=geo["threads"], smem=geo["smem"])

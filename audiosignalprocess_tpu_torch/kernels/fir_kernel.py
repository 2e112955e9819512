"""Direct-form FIR MAC: the hand-written Hopper kernel
(``csrc/fir_kernel.cu``) and its plain PyTorch version.

Causal y[n] = sum_t h[t] x[n-t] on the last axis, output length ==
len(x), with the T-1 samples before x from ``history`` (zeros when
absent): the semantics of ``ops.fir.fir_direct`` and of the JAX
package's ``kernels/fir_kernel.fir_mac``.

Routing: a CPU tensor runs ``fir_mac_ref``; a CUDA float32 tensor
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
from audiosignalprocess_tpu_torch.kernels.gate_kernel import regs_info
from audiosignalprocess_tpu_torch.ops.fir import fir_direct
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.profiling import kernel_wrapper
from audiosignalprocess_tpu_torch.utils.validate import check

OUTPUTS = 8
"""Consecutive outputs a thread computes (``kP`` of ``csrc/fir_kernel.cu``)."""

CHUNK = 16
"""Taps a chunk of the unrolled MAC (``kC``)."""

FIR_THREADS = 128
"""Threads a CTA: tiles of 1024 outputs, the retired kernel's, so every tap
count it took fits SMEM_LIMIT."""


def smem_bytes(taps: int) -> int:
    """Shared memory of one CTA: the reversed taps in whole chunks and the
    window a chunk may read (the tile of FIR_THREADS x OUTPUTS outputs and
    the taps in whole chunks)."""
    tp = -(-taps // CHUNK) * CHUNK
    return 4 * (2 * tp + FIR_THREADS * OUTPUTS)


def fir_geometry(taps: int) -> dict:
    """The launch for ``taps``: threads a CTA, outputs a CTA (the tile) and
    shared memory; a ValueError names SMEM_LIMIT past 28544 taps, where
    the retired kernel raised too."""
    check(taps >= 1, "fir_mac needs at least one tap")
    smem = smem_bytes(taps)
    check(smem <= SMEM_LIMIT, f"{taps} taps need {smem} bytes of shared memory per block, "
          f"more than SMEM_LIMIT ({SMEM_LIMIT})")
    return dict(threads=FIR_THREADS, smem=smem, tile=FIR_THREADS * OUTPUTS)


@functools.lru_cache(maxsize=32)
def reversed_taps(h_bytes: bytes, device: torch.device) -> torch.Tensor:
    """The taps reversed, float32 on ``device``, uploaded once per filter."""
    h = np.frombuffer(h_bytes, dtype=np.float64)
    return upload(h[::-1].copy(), torch.float32, device)


def fir_mac_ref(x: torch.Tensor, h, history: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``fir_direct`` (conv1d, TF32 off), any
    device and dtype."""
    return fir_direct(x, h, history=history)


@functools.cache
def _lib():
    fn = _build.load().asp_fir_mac
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@kernel_wrapper
def fir_mac(x: torch.Tensor, h, history: torch.Tensor | None = None) -> torch.Tensor:
    """Causal direct-form FIR on the last axis via the MAC kernel.

    A CPU tensor runs ``fir_mac_ref``.  A CUDA float32 tensor launches the
    kernel: one CTA per (tile of 1024 outputs, channel) (``fir_geometry``),
    taps and window in shared memory, 8 consecutive outputs a thread in
    registers.  Any other tensor raises.
    """
    h = np.ascontiguousarray(h, dtype=np.float64)
    t = len(h)
    check(t >= 1, "fir_mac needs at least one tap")
    if x.device.type == "cpu":
        return fir_mac_ref(x, h, history)
    check_cuda_f32(x, "fir_mac", "FIRStage routes float64 to the plain fir_direct")
    x2d, x_ld = rows_view(x)
    channels, n = x2d.shape
    check(n >= 1 and 0 < channels <= 65535,
          f"fir_mac takes 1..65535 channels of >= 1 sample, got {tuple(x2d.shape)}")
    hist = None
    if history is not None and t > 1:
        hist = history.reshape(channels, t - 1).contiguous()
        check(hist.dtype == torch.float32 and hist.device == x.device,
              "history must be float32 on the input's device")
    geo = fir_geometry(t)
    dev = x.device
    y = torch.empty((channels, n), dtype=torch.float32, device=dev)
    launch("fir_mac", _lib(), x2d.data_ptr(), x_ld, None if hist is None else hist.data_ptr(),
           y.data_ptr(), reversed_taps(h.tobytes(), dev).data_ptr(), channels, n, t,
           geo["threads"], geo["smem"], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    fir_mac.launches += 1
    return y.reshape(x.shape)


fir_mac.launches = 0


def fir_mac_info(taps: int = 129, device: torch.device | None = None) -> dict:
    """The built kernel at ``taps``' launch, from the CUDA runtime:
    registers a thread, local memory bytes a thread (spills) and resident
    CTAs an SM, with the launch's threads and shared memory."""
    geo = fir_geometry(taps)
    dev = torch.device("cuda") if device is None else device
    return dict(regs_info("asp_fir_mac_info", geo["threads"], None, geo["smem"], dev),
                threads=geo["threads"], smem=geo["smem"])

"""Polyphase rational resampler: the hand-written Hopper kernel
(``csrc/resample_kernel.cu``) and its plain PyTorch version.

Semantics of ``ops.resample.resample_poly`` (the oracle-pinned polyphase
convention, output ceil(n*up/down), or n*up/down with a streaming
``history``) and of the JAX package's ``kernels/resample_kernel.resample_mac``.

Routing: a CPU tensor runs ``resample_mac_ref``; a CUDA float32 tensor
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
from audiosignalprocess_tpu_torch.ops.resample import (
    phase_bank, reduce_ratio, resample_poly, stream_geometry, taps_per_phase,
)
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.validate import check

TILE = 1024
"""Outputs per CTA (``kTile`` of ``csrc/resample_kernel.cu``)."""


def res_window(count: int, up: int, down: int, nk: int) -> int:
    """Raw samples that ``count`` consecutive outputs read at most (the
    window ``asp::res_range`` stages)."""
    return -(-(count - 1) * down // up) + nk


@functools.lru_cache(maxsize=32)
def bank_table(h_bytes: bytes, up: int, device: torch.device) -> torch.Tensor:
    """The (up, nk) phase bank with each phase's taps reversed, float32 on
    ``device``, uploaded once per filter."""
    h = np.frombuffer(h_bytes, dtype=np.float64)
    return upload(np.ascontiguousarray(phase_bank(h, up)[:, ::-1]), torch.float32, device)


def resample_mac_ref(x: torch.Tensor, up: int, down: int, h=None,
                     zero_phase: bool = True,
                     history: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``ops.resample.resample_poly``, any device
    and dtype."""
    return resample_poly(x, up, down, h=h, zero_phase=zero_phase, history=history)


@functools.cache
def _lib():
    fn = _build.load().asp_resample_mac
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def resample_mac(x: torch.Tensor, up: int, down: int, h=None,
                 zero_phase: bool = True,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Rational resample on the last axis via the polyphase MAC kernel.

    A CPU tensor runs ``resample_mac_ref``.  A CUDA float32 tensor
    launches the kernel: one CTA per (1024 outputs, channel), phase bank
    and raw window in shared memory.  Any other tensor raises.
    """
    if x.device.type == "cpu":
        return resample_mac_ref(x, up, down, h, zero_phase, history)
    check_cuda_f32(x, "resample_mac", "ResampleStage routes float64 to the plain resample_poly")
    up, down, h = reduce_ratio(up, down, h)
    if h is None:
        return x
    x2d, x_ld = rows_view(x)
    channels, n = x2d.shape
    hn, nout = stream_geometry(n, up, down, len(h), history, zero_phase)
    check(nout >= 1 and 0 < channels <= 65535,
          f"resample_mac takes 1..65535 channels of >= 1 output, got {tuple(x2d.shape)}")
    hist = None
    if history is not None and hn:
        hist = history.reshape(channels, hn).contiguous()
        check(hist.dtype == torch.float32 and hist.device == x.device,
              "history must be float32 on the input's device")
    nk = taps_per_phase(len(h), up)
    smem = 4 * (up * nk + res_window(TILE, up, down, nk))
    check(smem <= SMEM_LIMIT, f"{up}/{down} with {len(h)} taps needs {smem} bytes of "
          f"shared memory per block, more than {SMEM_LIMIT}")
    dev = x.device
    y = torch.empty((channels, nout), dtype=torch.float32, device=dev)
    rc = _lib()(x2d.data_ptr(), x_ld, None if hist is None else hist.data_ptr(), hn,
                y.data_ptr(), bank_table(h.tobytes(), up, dev).data_ptr(),
                up, down, nk, (len(h) - 1) // 2 if zero_phase else 0,
                channels, n, nout, smem, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "resample_mac")
    resample_mac.launches += 1
    return y.reshape(x.shape[:-1] + (nout,))


resample_mac.launches = 0

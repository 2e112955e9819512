"""Overlap-save fast block convolution, pinned by ``oracle.overlap_save``.

Identical output to a causal direct-form FIR (length == len(x)): block
size B = nfft - (T-1); each block's input is the previous T-1 samples and
B new ones; the first T-1 outputs of each block are discarded.
``fused=True`` routes through the hand-written kernel
(``kernels/os_kernel.overlap_save_fused``, same semantics).
"""

from __future__ import annotations

import numpy as np
import torch

from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.validate import check


def spectrum_taps(h, nfft: int, dtype=np.complex64) -> np.ndarray:
    """rfft of the zero-padded taps (design time, float64 then cast)."""
    h = np.asarray(h, dtype=np.float64)
    hf = np.fft.rfft(np.concatenate([h, np.zeros(nfft - len(h))]))
    return hf.astype(dtype)


def overlap_save(x: torch.Tensor, h, nfft: int,
                 history: torch.Tensor | None = None,
                 impl: str = fft_ops.DEFAULT_IMPL,
                 fused: bool = False) -> torch.Tensor:
    """Causal FIR via overlap-save on the last axis; output length == input.

    ``history``: optional (..., T-1) previous inputs; zeros when absent.
    ``impl``: the FFT implementation (``ops.fft``).  An empty signal gives
    an empty (..., 0) result before any transform.
    """
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape)
    if fused:
        from audiosignalprocess_tpu_torch.kernels.os_kernel import overlap_save_fused

        return overlap_save_fused(x, h, nfft, history=history)
    h = np.asarray(h, dtype=np.float64)
    t = len(h)
    check(nfft > t - 1, "nfft must exceed numtaps-1")
    b = nfft - (t - 1)
    n = x.shape[-1]
    nblocks = -(-n // b)
    batch = x.shape[:-1]
    if history is None:
        head = x.new_zeros(batch + (t - 1,))
    else:
        head = history.to(x.dtype)
        check(head.shape[-1] == t - 1, "history must hold taps-1 samples")
    xp = torch.cat([head, x, x.new_zeros(batch + (nblocks * b - n,))], dim=-1)
    blocks = xp.unfold(-1, nfft, b)  # block k = xp[k*b : k*b + nfft]
    cdt = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    hf = upload(spectrum_taps(h, nfft, dtype=np.complex128), cdt, x.device)
    y = fft_ops.irfft(fft_ops.rfft(blocks, impl=impl) * hf, nfft, impl=impl)
    return y[..., t - 1 :].reshape(batch + (nblocks * b,))[..., :n]

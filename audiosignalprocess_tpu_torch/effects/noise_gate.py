"""Spectral noise gate, oracle-pinned.

Per-bin noise floor = mean |STFT| over the first ``noise_frames`` frames;
hard mask (attenuation ``10**(-reduction_db/20)`` where the magnitude is
at or below floor*10**(threshold_db/20)); optional max-with-decay release
of the mask along frames; WOLA resynthesis.
"""

from __future__ import annotations

import torch

from audiosignalprocess_tpu_torch.ops import fft as fft_ops
from audiosignalprocess_tpu_torch.ops.stft import istft, num_frames, stft
from audiosignalprocess_tpu_torch.utils.validate import check


def gate_mask(mag: torch.Tensor, floor: torch.Tensor, threshold_db: float,
              reduction_db: float, release: float = 0.0) -> torch.Tensor:
    """Mask from magnitudes and a per-bin noise floor (frames axis = -2)."""
    thresh = floor * (10.0 ** (threshold_db / 20.0))
    att = 10.0 ** (-reduction_db / 20.0)
    # the attenuation as a tensor of mag's dtype: two Python scalars would
    # make a float32 mask and round att
    mask = torch.where(mag > thresh, 1.0, torch.full_like(mag, att))
    if release > 0.0:
        # release smoothing s_k = max(mask_k, r * s_{k-1}), frame by frame
        state = torch.zeros_like(mask[..., 0, :])
        rows = []
        for k in range(mask.shape[-2]):
            state = torch.maximum(mask[..., k, :], release * state)
            rows.append(state)
        mask = torch.stack(rows, dim=-2)
    return mask


def noise_gate(x: torch.Tensor, nfft: int = 1024, hop: int = 256,
               threshold_db: float = 6.0, reduction_db: float = 60.0,
               noise_frames: int = 8, release: float = 0.0,
               window_kind: str = "hann", impl: str = fft_ops.DEFAULT_IMPL,
               fused: bool = False) -> torch.Tensor:
    """Gate on the last axis.  Output length = istft length of the frames.

    ``impl``: the FFT implementation (``ops.fft``).  ``fused=True`` routes
    through ``kernels.gate_kernel.noise_gate_fused`` (the hand-written
    kernel on a CUDA float32 tensor, its plain version on a CPU tensor).
    """
    nframes = num_frames(x.shape[-1], nfft, hop)
    check(nframes >= noise_frames,
          f"signal has {nframes} frames < noise_frames={noise_frames}")
    if fused:
        from audiosignalprocess_tpu_torch.kernels.gate_kernel import noise_gate_fused

        return noise_gate_fused(x, nfft, hop, threshold_db, reduction_db,
                                noise_frames, release, window_kind)
    spec = stft(x, nfft, hop, window_kind, impl=impl)
    mag = spec.abs()
    floor = mag[..., :noise_frames, :].mean(dim=-2, keepdim=True)
    mask = gate_mask(mag, floor, threshold_db, reduction_db, release)
    return istft(spec * mask, nfft, hop, window_kind, impl=impl)

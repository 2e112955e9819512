"""Polyphase rational resampler, e.g. 44.1 -> 48 kHz = 160/147.

Convention pinned by the JAX package's ``cpu_ref/oracle.resample_poly``:
causal polyphase y[j] = sum_k h[p_j + up*k] * x[m_j - k] with
j*down + delay = m_j*up + p_j; ``zero_phase=True`` advances by the filter
group delay (delay = (len(h)-1)//2).  Output length = ceil(len(x)*up/down).

``resample_filter`` is a copy of ``oracle.resample_filter`` (the tests
hold the two bit-equal).  The plain path is a gather MAC over the
(up, nk) phase bank, taps in order, in the input's dtype;
``fused=True`` routes through the hand-written kernel
(``kernels/resample_kernel.resample_mac``, same semantics).
"""

from __future__ import annotations

from math import gcd

import numpy as np
import torch

from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.utils.device import upload
from audiosignalprocess_tpu_torch.utils.validate import check


def resample_filter(up: int, down: int, half_width: int = 10,
                    window_kind: str = "hann") -> np.ndarray:
    """Prototype lowpass for up/down resampling: windowed sinc at cutoff
    1/max(up, down) (Nyquist units of the upsampled rate), gain ``up``;
    2*half_width*max(up, down) + 1 taps (odd, type I)."""
    m = max(up, down)
    h = design_fir(2 * half_width * m + 1, 1.0 / m, window_kind=window_kind)
    return h * up


def taps_per_phase(h_len: int, up: int) -> int:
    """nk = ceil(len(h)/up): polyphase taps per phase."""
    return -(-h_len // up)


def history_len(h_len: int, up: int, down: int) -> int:
    """Streaming history: >= nk-1 input samples, rounded up to a multiple
    of ``down`` so the block output count stays integral."""
    nk = taps_per_phase(h_len, up)
    return -(-(nk - 1) // down) * down


def phase_bank(h: np.ndarray, up: int) -> np.ndarray:
    """(up, nk) float64: bank[p, k] = h[p + up*k], zero past the taps."""
    nk = taps_per_phase(len(h), up)
    return np.concatenate([h, np.zeros(up * nk - len(h))]).reshape(nk, up).T


def reduce_ratio(up: int, down: int, h=None) -> tuple[int, int, np.ndarray | None]:
    """(up, down) divided by their gcd, and the taps as float64 (the
    prototype ``resample_filter`` when ``h`` is None); None for 1/1."""
    g = gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return up, down, None
    h = resample_filter(up, down) if h is None else h
    return up, down, np.asarray(h, dtype=np.float64)


def stream_geometry(n: int, up: int, down: int, taps: int,
                    history: torch.Tensor | None, zero_phase: bool) -> tuple[int, int]:
    """Check the history contract; returns (history length hn, output
    count): n*up/down with a history, ceil(n*up/down) without."""
    if history is None:
        return 0, -(-n * up // down)
    check(not zero_phase, "streaming resample must be causal")
    hn = history.shape[-1]
    check(hn % down == 0 and n % down == 0,
          f"history ({hn}) and block ({n}) must be multiples of down={down}")
    check(hn >= taps_per_phase(taps, up) - 1,
          f"history {hn} shorter than the filter needs "
          f"({taps_per_phase(taps, up) - 1}); use history_len()")
    return hn, n * up // down


def resample_poly(x: torch.Tensor, up: int, down: int, h=None,
                  zero_phase: bool = True, history: torch.Tensor | None = None,
                  fused: bool = False) -> torch.Tensor:
    """Rational resample on the last axis; ceil(n*up/down) outputs.

    ``history``: optional (..., H) previous input samples for streaming
    (causal only; H and len(x) multiples of ``down``, H >= nk-1); returns
    the len(x)*up/down outputs of the new block, continuing the causal
    stream exactly.  ``fused=True`` routes through ``resample_mac``.
    """
    if fused:
        from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac

        return resample_mac(x, up, down, h=h, zero_phase=zero_phase, history=history)
    up, down, h = reduce_ratio(up, down, h)
    if h is None:
        return x
    n = x.shape[-1]
    hn, nout = stream_geometry(n, up, down, len(h), history, zero_phase)
    nk = taps_per_phase(len(h), up)
    delay = (len(h) - 1) // 2 if zero_phase else 0
    # in x's own coordinates output j reads x[m_j - k], m_j = (j*down +
    # delay) // up, with the history (or zeros) before x and zeros past it
    j = torch.arange(nout, dtype=torch.int64, device=x.device)
    pos = j * down + delay
    m, p = pos // up, pos % up
    m_last = (max(nout - 1, 0) * down + delay) // up
    head = (history.to(x.dtype) if history is not None
            else x.new_zeros(x.shape[:-1] + (nk - 1,)))
    xp = torch.cat([head, x, x.new_zeros(x.shape[:-1] + (max(0, m_last + 1 - n),))],
                   dim=-1)
    hl = head.shape[-1]
    bank = upload(phase_bank(h, up), x.dtype, x.device)
    out = x.new_zeros(x.shape[:-1] + (nout,))
    for k in range(nk):
        out = out + bank[p, k] * xp[..., m - k + hl]
    return out

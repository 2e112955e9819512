"""Exact fmaf in numpy, and the fmaf chains the port's MAC kernels are
bit-equal to, for the CPU models (``tests/test_torch_os_fir_regs.py``,
``tests/test_torch_resample_regs.py``) and the card
(``tests/test_torch_cuda.py``).  Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import numpy as np

from audiosignalprocess_tpu_torch.ops.resample import (
    phase_bank, reduce_ratio, stream_geometry, taps_per_phase,
)


def fmaf32(a, b, c):
    """fmaf on float32 arrays, exactly: the product is exact in float64,
    the sum's error exact by TwoSum, and the sum rounded to odd in float64
    (53 >= 24 + 2 bits) rounds once more to float32 correctly."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(np.int64)
    fix = (e != 0) & ((bits & 1) == 0)
    bits = np.where(fix, bits + np.where((e > 0) == (s > 0), 1, -1), bits)
    return bits.view(np.float64).astype(np.float32)


def resample_fmaf_reference(x, up, down, h=None, zero_phase=True, hist=None):
    """The polyphase fmaf chains in tap order on float32 x (C, n): output j
    = fmaf over t = 0 .. nk-1 of bank[p][t] raw[m - (nk-1) + t] from 0,
    with j*down + delay = m*up + p, bank each phase's float32 taps reversed
    (``resample_kernel.bank_table``) and raw [hist (or zeros) | x | zeros]
    in float32: ``resample_mac``'s semantics, one rounding a tap."""
    x = np.asarray(x, np.float32)
    up, down, h = reduce_ratio(up, down, h)
    n_ch, n = x.shape
    nk = taps_per_phase(len(h), up)
    hn, nout = stream_geometry(n, up, down, len(h), None if hist is None else np.asarray(hist),
                               zero_phase)
    delay = (len(h) - 1) // 2 if zero_phase else 0
    bank = np.ascontiguousarray(phase_bank(h, up)[:, ::-1]).astype(np.float32)
    pos = np.arange(nout, dtype=np.int64) * down + delay
    m, p = pos // up, pos % up
    lead = max(hn, nk - 1)  # raw index -lead is column 0
    pre = np.zeros((n_ch, lead), np.float32)
    if hn:
        pre[:, lead - hn:] = np.asarray(hist, np.float32)
    tail = np.zeros((n_ch, max(0, int(m[-1]) + 1 - n)), np.float32)
    raw = np.concatenate([pre, x, tail], axis=1)
    acc = np.zeros((n_ch, nout), np.float32)
    for t in range(nk):
        acc = fmaf32(bank[p, t], raw[:, m - (nk - 1) + t + lead], acc)
    return acc

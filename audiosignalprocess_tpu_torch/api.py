"""File-level one-shot API: read a WAV, run the chain, write a WAV.

    from audiosignalprocess_tpu_torch import api
    api.chain_file("in.wav", "out.wav", block=4096, envelope_hz=50.0, device="cuda")

The FIR -> noise-gate (-> envelope) chain for a file already at
``rate_out``, whole file or block-streamed; the resampler front end
(``rate_out`` other than the file's rate) is not ported yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.pipeline import Chain, FIRGateStage


def chain_file(path_in: str, path_out: str, rate_out: int = 48000,
               cutoff_hz: float | None = None, numtaps: int = 64,
               nfft: int = 1024, hop: int = 256,
               threshold_db: float = 6.0, reduction_db: float = 60.0,
               noise_frames: int = 8, envelope_hz: float | None = None,
               env_numtaps: int = 129, block: int | None = None,
               device: torch.device | str = "cpu", **wav_kw):
    """FIR lowpass (``cutoff_hz``, default 0.3*Nyquist) -> spectral noise
    gate -> optional envelope demod (``envelope_hz``) on a WAV file at
    ``rate_out``, on ``device``.  With ``block`` the file streams through
    ``Chain.stream(drain=True)``, one fused step per block; without it the
    whole file runs at once.  Both write exactly ``len(x)`` samples per
    channel; returns the output shape."""
    x, rate = read_wav(path_in)
    if Fraction(rate_out, rate) != 1:
        raise NotImplementedError(
            f"resampling {rate} Hz -> {rate_out} Hz is not ported yet "
            f"(ROADMAP Queue 1: the resampler family)")
    fc = 2.0 * cutoff_hz / rate_out if cutoff_hz is not None else 0.3
    env_h = (design_fir(env_numtaps, 2.0 * envelope_hz / rate_out)
             if envelope_hz is not None else None)
    chain = Chain([FIRGateStage(
        h=design_fir(numtaps, fc), nfft=nfft, hop=hop,
        threshold_db=threshold_db, reduction_db=reduction_db,
        noise_frames=noise_frames, env_h=env_h)])
    chain.build()
    xt = torch.from_numpy(x).to(device)
    y = chain.stream(xt, block, drain=True) if block is not None else chain.full_flush(xt)
    y = y.cpu().numpy()
    write_wav(path_out, y, rate_out, **wav_kw)
    return y.shape

"""File-level one-shot API: read a WAV, run the chain, write a WAV.

    from audiosignalprocess_tpu_torch import api
    api.chain_file("in.wav", "out.wav", block=4704, envelope_hz=50.0, device="cuda")
    api.resample_file("cd.wav", "dat.wav", rate_out=48000, device="cuda")

``chain_file``: resample to ``rate_out`` (when the file is at another
rate) -> FIR lowpass -> noise gate (-> envelope), whole file or
block-streamed.  ``resample_file``: the resampler alone.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.ops.resample import resample_poly
from audiosignalprocess_tpu_torch.pipeline import Chain, FIRGateStage, ResFIRGateStage


def resample_file(path_in: str, path_out: str, rate_out: int,
                  device: torch.device | str = "cpu", **wav_kw):
    """Polyphase rational resample to ``rate_out`` (e.g. 44100 -> 48000),
    zero-phase, on ``device``: the hand-written ``resample_mac`` on a CUDA
    device, its plain version on the CPU.  Returns the output shape."""
    x, rate = read_wav(path_in)
    fr = Fraction(rate_out, rate)
    y = resample_poly(torch.from_numpy(x).to(device), fr.numerator, fr.denominator,
                      fused=True).cpu().numpy()
    write_wav(path_out, y, rate_out, **wav_kw)
    return y.shape


def chain_file(path_in: str, path_out: str, rate_out: int = 48000,
               cutoff_hz: float | None = None, numtaps: int = 64,
               nfft: int = 1024, hop: int = 256,
               threshold_db: float = 6.0, reduction_db: float = 60.0,
               noise_frames: int = 8, envelope_hz: float | None = None,
               env_numtaps: int = 129, block: int | None = None,
               device: torch.device | str = "cpu", **wav_kw):
    """The config-5 chain on a WAV file, on ``device``: resample to
    ``rate_out`` (when the file is at another rate) -> FIR lowpass
    (``cutoff_hz``, default 0.3*Nyquist) -> spectral noise gate ->
    optional envelope demod (``envelope_hz``).  With ``block`` the file
    streams through ``Chain.stream(drain=True)``, one fused step per block
    (a multiple of the chain's input quantum when it resamples:
    ``kernels.res_chain_kernel.res_step_geometry``); without it the whole
    file runs at once.  Both write exactly ``Chain.out_len(len(x))``
    samples per channel; returns the output shape."""
    x, rate = read_wav(path_in)
    fr = Fraction(rate_out, rate)
    fc = 2.0 * cutoff_hz / rate_out if cutoff_hz is not None else 0.3
    env_h = (design_fir(env_numtaps, 2.0 * envelope_hz / rate_out)
             if envelope_hz is not None else None)
    kw = dict(h=design_fir(numtaps, fc), nfft=nfft, hop=hop, threshold_db=threshold_db,
              reduction_db=reduction_db, noise_frames=noise_frames, env_h=env_h)
    # a file already at rate_out has no resampler (a 1/1 polyphase stage has
    # no prototype filter: its cutoff would sit at Nyquist)
    chain = Chain([FIRGateStage(**kw) if fr == 1 else
                   ResFIRGateStage(up=fr.numerator, down=fr.denominator, **kw)])
    chain.build()
    xt = torch.from_numpy(x).to(device)
    y = chain.stream(xt, block, drain=True) if block is not None else chain.full_flush(xt)
    y = y.cpu().numpy()
    write_wav(path_out, y, rate_out, **wav_kw)
    return y.shape

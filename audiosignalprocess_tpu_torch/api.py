"""File-level one-shot API: read a WAV, run one effect or the chain, write
a WAV.  Every call runs on ``device``, the GPU unless the caller asks
for the CPU (``device="cpu"``); without a GPU the default raises torch's
own error.

    from audiosignalprocess_tpu_torch import api
    api.chain_file("in.wav", "out.wav", block=4704, envelope_hz=50.0)
    api.noise_gate_file("noisy.wav", "clean.wav")
    api.lowpass_file("in.wav", "low.wav", cutoff_hz=2000)
    api.resample_file("cd.wav", "dat.wav", rate_out=48000, device="cpu")
    api.pitch_shift_file("voice.wav", "high.wav", semitones=4)

``chain_file``: resample to ``rate_out`` (when the file is at another
rate) -> FIR lowpass -> noise gate (-> envelope), whole file or
block-streamed.  ``resample_file``: the resampler alone.  The one-shots
of the JAX package's ``api``: ``lowpass_file`` (config 1),
``bandpass_file`` (config 2's filter), ``noise_gate_file`` (config 3),
``envelope_file``, and the phase vocoder's ``time_stretch_file`` and
``pitch_shift_file``.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from audiosignalprocess_tpu_torch.effects.noise_gate import noise_gate
from audiosignalprocess_tpu_torch.effects.phase_vocoder import pitch_shift, time_stretch
from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav
from audiosignalprocess_tpu_torch.ops.fir import design_fir, fir_direct
from audiosignalprocess_tpu_torch.ops.overlap_save import overlap_save
from audiosignalprocess_tpu_torch.ops.resample import resample_poly
from audiosignalprocess_tpu_torch.pipeline import (
    Chain, EnvelopeStage, FIRGateStage, ResFIRGateStage,
)


def _process(path_in: str, path_out: str, fn, device, rate_out=None, **wav_kw):
    """Read -> ``fn(x, rate)`` on ``device`` -> write at ``rate_out`` (the
    input's rate when None).  Returns the output shape."""
    x, rate = read_wav(path_in)
    y = fn(torch.from_numpy(x).to(device), rate).cpu().numpy()
    write_wav(path_out, y, rate_out or rate, **wav_kw)
    return y.shape


def resample_file(path_in: str, path_out: str, rate_out: int,
                  device: torch.device | str = "cuda", **wav_kw):
    """Polyphase rational resample to ``rate_out`` (e.g. 44100 -> 48000),
    zero-phase, on ``device``: the hand-written ``resample_mac`` on a CUDA
    device, its plain version on the CPU.  Returns the output shape."""

    def fn(x, rate):
        fr = Fraction(rate_out, rate)
        return resample_poly(x, fr.numerator, fr.denominator, fused=True)

    return _process(path_in, path_out, fn, device, rate_out, **wav_kw)


def chain_file(path_in: str, path_out: str, rate_out: int = 48000,
               cutoff_hz: float | None = None, numtaps: int = 64,
               nfft: int = 1024, hop: int = 256,
               threshold_db: float = 6.0, reduction_db: float = 60.0,
               noise_frames: int = 8, envelope_hz: float | None = None,
               env_numtaps: int = 129, block: int | None = None,
               device: torch.device | str = "cuda", **wav_kw):
    """The config-5 chain on a WAV file, on ``device``: resample to
    ``rate_out`` (when the file is at another rate) -> FIR lowpass
    (``cutoff_hz``, default 0.3*Nyquist) -> spectral noise gate ->
    optional envelope demod (``envelope_hz``).  With ``block`` the file
    streams through ``Chain.stream(drain=True)``, one fused step per block
    (a multiple of the chain's input quantum when it resamples:
    ``kernels.res_chain_kernel.res_step_geometry``); without it the whole
    file runs at once.  Both write exactly ``Chain.out_len(len(x))``
    samples per channel; returns the output shape."""
    fc = 2.0 * cutoff_hz / rate_out if cutoff_hz is not None else 0.3
    env_h = (design_fir(env_numtaps, 2.0 * envelope_hz / rate_out)
             if envelope_hz is not None else None)
    kw = dict(h=design_fir(numtaps, fc), nfft=nfft, hop=hop, threshold_db=threshold_db,
              reduction_db=reduction_db, noise_frames=noise_frames, env_h=env_h)

    def fn(x, rate):
        fr = Fraction(rate_out, rate)
        # a file already at rate_out has no resampler (a 1/1 polyphase stage
        # has no prototype filter: its cutoff would sit at Nyquist)
        chain = Chain([FIRGateStage(**kw) if fr == 1 else
                       ResFIRGateStage(up=fr.numerator, down=fr.denominator, **kw)])
        chain.build()
        return chain.stream(x, block, drain=True) if block is not None else chain.full_flush(x)

    return _process(path_in, path_out, fn, device, rate_out, **wav_kw)


def lowpass_file(path_in: str, path_out: str, cutoff_hz: float, numtaps: int = 64,
                 nfft: int = 1024, device: torch.device | str = "cuda", **wav_kw):
    """Windowed-sinc FIR lowpass by overlap-save (config 1): on a CUDA
    device its FFTs are ``rfft_stockham`` and ``irfft_stockham``."""

    def fn(x, rate):
        return overlap_save(x, design_fir(numtaps, 2.0 * cutoff_hz / rate), nfft)

    return _process(path_in, path_out, fn, device, **wav_kw)


def bandpass_file(path_in: str, path_out: str, lo_hz: float, hi_hz: float,
                  numtaps: int = 256, device: torch.device | str = "cuda", **wav_kw):
    """Windowed-sinc FIR bandpass in direct form (config 2's filter): the
    hand-written ``fir_mac`` on a CUDA device."""

    def fn(x, rate):
        h = design_fir(numtaps, (2.0 * lo_hz / rate, 2.0 * hi_hz / rate),
                       window_kind="hamming", pass_zero=False)
        return fir_direct(x, h, fused=True)

    return _process(path_in, path_out, fn, device, **wav_kw)


def noise_gate_file(path_in: str, path_out: str, nfft: int = 1024, hop: int = 256,
                    threshold_db: float = 6.0, reduction_db: float = 60.0,
                    noise_frames: int = 8, device: torch.device | str = "cuda",
                    **wav_kw):
    """Spectral noise gate (config 3): the hand-written ``noise_gate_fused``
    on a CUDA device.  Writes nfft + (F-1)*hop samples per channel."""

    def fn(x, rate):
        return noise_gate(x, nfft, hop, threshold_db, reduction_db, noise_frames,
                          fused=True)

    return _process(path_in, path_out, fn, device, **wav_kw)


def envelope_file(path_in: str, path_out: str, cutoff_hz: float = 50.0,
                  numtaps: int = 129, device: torch.device | str = "cuda", **wav_kw):
    """Envelope follower (|x| -> FIR lowpass -> * pi/2): the hand-written
    ``fir_mac`` on a CUDA device."""

    def fn(x, rate):
        return EnvelopeStage(design_fir(numtaps, 2.0 * cutoff_hz / rate), fused=True).full(x)

    return _process(path_in, path_out, fn, device, **wav_kw)


def time_stretch_file(path_in: str, path_out: str, rate_factor: float, nfft: int = 1024,
                      hop: int = 256, device: torch.device | str = "cuda", **wav_kw):
    """Phase-vocoder time stretch (``rate_factor`` > 1 speeds up): on a
    CUDA device its STFT and ISTFT run ``rfft_stockham`` and
    ``irfft_stockham``."""

    def fn(x, rate):
        return time_stretch(x, rate_factor, nfft, hop)

    return _process(path_in, path_out, fn, device, **wav_kw)


def pitch_shift_file(path_in: str, path_out: str, semitones: float, nfft: int = 1024,
                     hop: int = 256, device: torch.device | str = "cuda", **wav_kw):
    """Phase-vocoder pitch shift by ``semitones``: on a CUDA device the
    time stretch's ``rfft_stockham`` and ``irfft_stockham``, then the
    hand-written ``resample_mac``."""

    def fn(x, rate):
        return pitch_shift(x, semitones, nfft, hop)

    return _process(path_in, path_out, fn, device, **wav_kw)

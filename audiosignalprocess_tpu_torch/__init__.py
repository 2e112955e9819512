"""audiosignalprocess_tpu_torch: the PyTorch and CUDA port of audiosignalprocess_tpu.

The JAX/Pallas package ``audiosignalprocess_tpu`` is the reference; this
package computes the same things with PyTorch tensors, and its kernels
are written by hand for NVIDIA Hopper (CUDA C++ in ``csrc/``, built with
nvcc at first use).  It never imports jax.

Ported so far: windows, FIR design and direct-form filtering, the FFT
family (``ops.fft``: torch.fft, radix-2, split-radix, the four-step
matmul and the hand-written Stockham, four-step, radix-2 and Pease
kernels, ``auto`` picking the Stockham kernels for CUDA float32),
STFT/ISTFT, overlap-save, the polyphase resampler, the spectral noise
gate, the envelope effects, the phase vocoder (``effects.time_stretch``,
``effects.pitch_shift``), the (resample ->) FIR -> gate (-> envelope)
chain and the streaming vocoder in ``pipeline.Chain`` with whole-file and
block-streaming modes (``FIRStage``, ``GateStage``, ``EnvelopeStage``,
``FIRGateStage``, ``ResampleStage``, ``ResFIRGateStage``,
``StretchStage``), channel/time sharding over torch.distributed
(``parallel``: a (channel, time) mesh of processes, halo exchange, the
sharded FIR, overlap-save, resampler, gate, stretch and chain),
checkpointable carries, WAV I/O, the roofline model and the debug and
profiling helpers (``utils``) and the one-shots
``api.chain_file``, ``api.resample_file``, ``api.lowpass_file``,
``api.bandpass_file``, ``api.noise_gate_file``, ``api.envelope_file``,
``api.time_stretch_file`` and ``api.pitch_shift_file``, which run on the
GPU unless told ``device="cpu"``.  Hand-written kernels (``kernels/``):
``fir_noise_gate_fused``, ``fir_gate_step_fused``, ``gate_step_fused``,
``overlap_save_fused``, ``fir_mac``, ``resample_mac``,
``resample_fir_gate_fused``, ``res_fir_gate_step_fused``,
``noise_gate_fused``, ``fft_stockham_lanes``, ``rfft_stockham``,
``irfft_stockham``, ``stretch_step_fused``, ``gate_shard_fused``,
``fft_fourstep``, ``fft_radix2_lanes``, ``fft_radix2_stages``,
``fft_pease_lanes`` and ``fft_stockham_manual`` (behind
``ASP_SK_PIPE=manual``): every kernel of the JAX package.
"""

__version__ = "0.1.0"

from audiosignalprocess_tpu_torch.ops import windows, fft, stft, fir, overlap_save, resample  # noqa: F401
from audiosignalprocess_tpu_torch import effects, io  # noqa: F401
from audiosignalprocess_tpu_torch.pipeline import Chain  # noqa: F401
from audiosignalprocess_tpu_torch import api, kernels, parallel  # noqa: F401

"""audiosignalprocess_tpu_torch: the PyTorch and CUDA port of audiosignalprocess_tpu.

The JAX/Pallas package ``audiosignalprocess_tpu`` is the reference; this
package computes the same things with PyTorch tensors, and its kernels
are written by hand for NVIDIA Hopper (CUDA C++ in ``csrc/``, built with
nvcc at first use).  It never imports jax.

Ported so far: windows, FIR design and direct-form filtering, the FFT
family (torch.fft), STFT/ISTFT, overlap-save, the spectral noise gate, the
envelope effects, the FIR -> gate (-> envelope) chain in ``pipeline.Chain``
with whole-file and block-streaming modes (``FIRStage``, ``GateStage``,
``EnvelopeStage``, ``FIRGateStage``), checkpointable carries, WAV I/O and
``api.chain_file``.  Hand-written kernels (``kernels/``):
``fir_noise_gate_fused``, ``fir_gate_step_fused``, ``gate_step_fused``,
``overlap_save_fused`` and ``fir_mac``.
"""

__version__ = "0.1.0"

from audiosignalprocess_tpu_torch.ops import windows, fft, stft, fir, overlap_save  # noqa: F401
from audiosignalprocess_tpu_torch import effects, io  # noqa: F401
from audiosignalprocess_tpu_torch.pipeline import Chain  # noqa: F401
from audiosignalprocess_tpu_torch import api, kernels  # noqa: F401

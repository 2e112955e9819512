"""audiosignalprocess_tpu_torch: the PyTorch and CUDA port of audiosignalprocess_tpu.

The JAX/Pallas package ``audiosignalprocess_tpu`` is the reference; this
package computes the same things with PyTorch tensors, and its kernels
are written by hand for NVIDIA Hopper (CUDA C++ in ``csrc/``, built with
nvcc at first use).  It never imports jax.

Ported so far: windows, FIR design, the FFT family (torch.fft), STFT/ISTFT,
overlap-save, the spectral noise gate, the whole-file FIR -> gate chain
(``pipeline.Chain`` with ``FIRGateStage``) whose fused kernel is
``kernels.chain_kernel.fir_noise_gate_fused``, WAV I/O and
``api.chain_file``.
"""

__version__ = "0.1.0"

from audiosignalprocess_tpu_torch.ops import windows, fft, stft, fir, overlap_save  # noqa: F401
from audiosignalprocess_tpu_torch import effects, io  # noqa: F401
from audiosignalprocess_tpu_torch.pipeline import Chain  # noqa: F401
from audiosignalprocess_tpu_torch import api, kernels  # noqa: F401

"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for a CUDA float32 tensor and runs
its plain version for a CPU tensor.  The CUDA sources live in ``csrc/``
and are built with nvcc at first use (``kernels/_build.py``).
"""

from audiosignalprocess_tpu_torch.kernels.chain_kernel import (  # noqa: F401
    fir_gate_step_fused, fir_noise_gate_fused,
)
from audiosignalprocess_tpu_torch.kernels.fft_kernel import (  # noqa: F401
    fft_complex, fft_fourstep, fft_pease_lanes, fft_radix2_lanes, fft_radix2_stages,
    fft_stockham_lanes, fft_stockham_manual, irfft_stockham, rfft_stockham,
)
from audiosignalprocess_tpu_torch.kernels.fir_kernel import fir_mac  # noqa: F401
from audiosignalprocess_tpu_torch.kernels.gate_kernel import (  # noqa: F401
    gate_shard_fused, gate_step_fused, noise_gate_fused,
)
from audiosignalprocess_tpu_torch.kernels.os_kernel import overlap_save_fused  # noqa: F401
from audiosignalprocess_tpu_torch.kernels.res_chain_kernel import (  # noqa: F401
    res_fir_gate_step_fused, resample_fir_gate_fused,
)
from audiosignalprocess_tpu_torch.kernels.resample_kernel import resample_mac  # noqa: F401
from audiosignalprocess_tpu_torch.kernels.stretch_kernel import stretch_step_fused  # noqa: F401

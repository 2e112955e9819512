"""Moving design-time numpy constants (windows, tap spectra, norm tables)
onto the device of the data."""

from __future__ import annotations

import numpy as np
import torch

from audiosignalprocess_tpu_torch.utils.profiling import count_upload


def upload(a: np.ndarray, dtype: torch.dtype,
           device: torch.device | str | None) -> torch.Tensor:
    """``a`` as a tensor of ``dtype`` on ``device``.

    To a CUDA device the copy goes from pinned host memory without
    blocking the host: a copy from pageable memory synchronizes the
    stream, so every call would wait for the work queued before it.
    Each copy to a CUDA device counts in ``profiling.counters()``.
    """
    if device is not None and torch.device(device).type == "cuda":
        host = torch.as_tensor(a, dtype=dtype).pin_memory()
        count_upload(host.nbytes)
        return host.to(device, non_blocking=True)
    return torch.as_tensor(a, dtype=dtype, device=device)

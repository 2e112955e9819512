from audiosignalprocess_tpu_torch.ops import (  # noqa: F401
    fft,
    fir,
    overlap_save,
    resample,
    stft,
    windows,
)

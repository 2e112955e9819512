from audiosignalprocess_tpu_torch.effects.noise_gate import gate_mask, noise_gate  # noqa: F401
from audiosignalprocess_tpu_torch.effects.phase_vocoder import pitch_shift, time_stretch  # noqa: F401

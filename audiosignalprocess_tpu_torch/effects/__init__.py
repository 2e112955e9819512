from audiosignalprocess_tpu_torch.effects.noise_gate import gate_mask, noise_gate  # noqa: F401

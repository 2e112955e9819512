from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav  # noqa: F401

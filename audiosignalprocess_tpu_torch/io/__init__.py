from audiosignalprocess_tpu_torch.io.wav import read_wav, write_wav, stream_blocks  # noqa: F401

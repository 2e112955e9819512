from audiosignalprocess_tpu_torch.utils.metrics import snr_db  # noqa: F401

"""Training steps of the port (counterpart of `lav_tpu/train/`)."""

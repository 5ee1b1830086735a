"""Port of horovod_tpu/models."""

"""Port of horovod_tpu/utils."""

"""Port of horovod_tpu/common."""

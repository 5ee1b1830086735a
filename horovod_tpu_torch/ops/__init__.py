"""Port of horovod_tpu/ops."""

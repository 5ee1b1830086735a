"""Port of horovod_tpu/parallel: the mesh and sequence parallelism."""

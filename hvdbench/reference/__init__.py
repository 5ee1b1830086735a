"""The plain references: float32 PyTorch with TF32 off, one file a family,
and the lower-precision control (:mod:`.lowp`). Nothing here imports the
program, JAX or the JAX package; the weights and inputs come from the
harness (``weights.py`` and the families' batch makers), never from the
program's state."""

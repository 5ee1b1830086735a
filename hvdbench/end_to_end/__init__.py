"""End-to-end metric readers, one file a metric, loaded by name."""

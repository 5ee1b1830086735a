"""Scripts that drive the port end to end."""

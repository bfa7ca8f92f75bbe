"""Builder, checkpoint I/O and weight conversion."""

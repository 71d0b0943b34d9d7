"""Multi-sequence (batched) mode of the port."""

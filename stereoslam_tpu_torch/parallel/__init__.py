"""Multi-sequence (batched) mode and multi-device meshes of the port."""

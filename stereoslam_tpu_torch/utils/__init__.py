"""numpy-only helpers: trajectory IO, metrics, synthetic sequences."""

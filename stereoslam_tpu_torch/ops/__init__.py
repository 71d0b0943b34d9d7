"""Fixed-shape PyTorch ops: geometry, image, LK, LM, FAST, BA."""

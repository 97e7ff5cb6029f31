"""Plain PyTorch tensor ops of the LFT forward and the scene pipeline."""

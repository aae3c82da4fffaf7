"""Dense decoder-only models on PyTorch."""

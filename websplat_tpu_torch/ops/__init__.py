"""Frame stages: plain PyTorch versions and their CUDA kernel wrappers."""

"""The plain PyTorch references of the benchmark's comparisons."""

"""Hand-written CUDA kernels (csrc/*.cu, built by _build.py) and their
plain PyTorch versions."""
